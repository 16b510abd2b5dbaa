"""Drivers: step functions (``steps``), the training loop (``train``), the
abstract meshes and their rules (``mesh``), input specs (``specs``), and the
tools that size a cell without running it on a card: the ``meta``-device
dry-run (``dryrun``), the roofline (``roofline``) and the hillclimb
(``hillclimb``)."""
