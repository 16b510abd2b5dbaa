"""Drivers: step functions (``steps``) and the training loop (``train``).
The reference's mesh, dry-run and roofline tools are queue 1 item 15."""
