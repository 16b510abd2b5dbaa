"""K2-K5 refuse to launch under grad: none of them has a backward, and a
launch into a fresh output would cut the autograd graph without a word.

Imports torch and the port only, so that the test that needs the card runs
there: ``python -m pytest -m card tests/test_torch_card.py``.
"""
import pytest
import torch

from repro_torch.kernels import _build

def test_refuse_grad_raises_only_while_recording_a_grad_input():
    a = torch.ones(3, requires_grad=True)
    b, idx = torch.ones(3), torch.ones(3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward.*blocked"):
        _build.refuse_grad("flash_attention", b, a, idx)
    _build.refuse_grad("flash_attention", b, idx)
    with torch.no_grad():
        _build.refuse_grad("flash_attention", a, b)
    with torch.inference_mode():
        _build.refuse_grad("flash_attention", a, b)


@pytest.mark.card
def test_kernels_raise_under_grad_and_launch_under_no_grad_on_the_card():
    """K2-K5 on the card: an input that requires grad raises while autograd
    records; under ``no_grad`` each launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wrappers launch their kernels "
                    "(and refuse to under grad) only on a card")
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import rg_lru as k5
    from repro_torch.kernels import ssd_scan as k4
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k, v = r(1, 8, 2, 64), r(1, 8, 1, 64), r(1, 8, 1, 64)
    cs = -torch.rand(1, 1, 16, 2, generator=g, device=dev).cumsum(2)
    cases = [(k2, k2.flash_attention, (q, k, v), {}),
             (k3, k3.decode_attention,
              (r(1, 1, 2, 64), k, v, torch.ones(8, dtype=torch.bool,
                                                device=dev)), {}),
             (k4, k4.ssd_scan, (r(1, 1, 16, 2, 16), r(1, 1, 16, 2).abs(), cs,
                                r(1, 1, 16, 16), r(1, 1, 16, 16)), {}),
             (k5, k5.rg_lru, (torch.rand(1, 8, 4, generator=g, device=dev),
                              r(1, 8, 4)), {})]
    for mod, fn, args, kw in cases:
        args[0].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args, **kw)
        before = mod.launches
        with torch.no_grad():
            fn(*args, **kw)
        assert mod.launches == before + 1
        args[0].requires_grad_(False)


@pytest.mark.card
def test_sharded_sweep_on_virtual_shards_of_the_card_is_repeatable():
    """A small sweep over 4 virtual shards of ``cuda:0`` (a block of lanes
    on a stream each), run twice: both runs equal the unsharded sweep bit
    for bit, static and with the DTPM policy lanes streaming, and K1
    launches once a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shards are blocks of lanes on "
                    "streams of cuda:0, and K1 launches only on a card")
    import numpy as np

    from repro_torch.dse import DesignPoint
    from repro_torch.kernels import epoch_scan as k1
    from repro_torch.scenario import Scenario, TraceSpec, sweep
    from repro_torch.sharding import virtual_lane_devices
    scn = Scenario(apps=("wifi_tx", "wifi_rx"), scheduler="etf",
                   governor="design",
                   trace=TraceSpec(rate_jobs_per_ms=20.0, num_jobs=200,
                                   seed=1))
    points = [DesignPoint(cross_cluster_penalty=1.0 + 0.25 * i)
              for i in range(10)]
    cases = [(scn, {"design": points, "seed": [0, 1, 2]}),
             (scn.replace(governor="ondemand"),
              {"design": points[:2], "governor_params": [
                  (("up_threshold", 0.5 + 0.05 * i),) for i in range(8)]})]
    fields = ("avg_latency_us", "makespan_us", "energy_j", "peak_temp_c",
              "busy_per_pe_us")
    for base, axes in cases:
        plain = sweep(base, axes, shard=False)
        for _ in range(2):
            before = k1.launches
            with virtual_lane_devices(4):
                got = sweep(base, axes)
            assert k1.launches == before + 4
            for f in fields:
                assert np.array_equal(getattr(got, f), getattr(plain, f)), f
