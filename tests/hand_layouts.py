"""Collectives derived by hand from the sharding rules, the expected
events of ``tests/test_torch_collectives.py`` and of ``chip_smoke.py``
phase 15 (b): one list, read by both.  Imports nothing."""


def granite_prefill_by_hand() -> list:
    """Every collective of reduced granite-3-8b's prefill (B=4, S=64, f32,
    D=64, H=4, KV=2, Dh=16, F=128, V=256, tied embeddings, 2 global layers)
    on (data=2, model=4) under the prefill rules (batch and fsdp on data;
    model and q_seq on model): (kind, result bytes on rank 0, group)."""
    B, S, D, H, KV, Dh, F, V, f4 = 4, 64, 64, 4, 2, 16, 128, 256, 4
    dp, mp = 2, 4
    AG, AR, A2A = "all-gather", "all-reduce", "all-to-all"
    embed = [
        (AG, B * S * 4, dp),              # int32 tokens whole for the lookup
        # the lookup in a table split (V on model, D on data): its partial
        # sum over model reduced, then D -> B on data ("batch", None, None)
        (AR, B * S * D // dp * f4, mp),
        (A2A, B // dp * S * D * f4, dp),
    ]
    kv = B // dp * S * KV * Dh * f4
    layer = [
        (AG, D * H * Dh // mp * f4, dp),             # wq whole over fsdp
        (A2A, B // dp * S // mp * H * Dh * f4, mp),  # q: heads -> q_seq
        (AG, D * KV * Dh // mp * f4, dp),            # wk over fsdp
        (AG, kv, mp),                  # 2 KV heads do not split 4 ways
        (AG, D * KV * Dh // mp * f4, dp),            # wv over fsdp
        (AG, kv, mp),                                # v likewise
        (AG, kv, mp), (AG, kv, mp),    # _attend_cp: k and v whole over q_seq
        (A2A, B // dp * S * H * Dh // mp * f4, mp),  # _unproj: q_seq -> model
        (AG, H * Dh // mp * D * f4, dp),             # wo over fsdp
        (AR, B // dp * S * D * f4, mp),  # wo's partial sum over heads
        (AG, D * F // mp * f4, dp),                  # w_in over fsdp
        (AG, D * F // mp * f4, dp),                  # w_gate over fsdp
        (AG, F // mp * D * f4, dp),                  # w_out over fsdp
        (AR, B // dp * S * D * f4, mp),  # w_out's partial sum over mlp
    ]
    head = [(AG, V // mp * D * f4, dp)]              # tied table over fsdp
    return embed + layer * 2 + head
