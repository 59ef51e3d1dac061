"""On-card checks of the port's kernels (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false (the CPU tier-1
run); on a Hopper card run them with ``python -m pytest tests/test_torch_cuda.py
-m cuda``.  ``chip_smoke.py`` makes the same checks at the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import build  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import compact as k2  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels compile for sm_90a with nvcc)")
    return torch.device("cuda")


@pytest.mark.parametrize("pot,signed", [("gauss", True), ("banana", False)])
def test_k1_kernel_matches_plain_f64(dev, pot, signed):
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.ZigZag(6, grad, signed_bound=signed)
    rs = np.random.default_rng(0)
    state = sampler.init_state_batch(rs.normal(size=(300, 6)),
                                     rs.choice([-1.0, 1.0], size=(300, 6)),
                                     3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 20, 128)
    st_k = driver.chunk_state(state, torch.zeros(300, dtype=torch.int32, device=dev))
    st_p = k1.ChunkState(*(a.clone() for a in st_k))
    fills = [k1.empty_fill(32, 6, 300, torch.float64, dev) for _ in range(2)]
    n0 = build.LAUNCHES["zigzag_chunk"]
    for it in range(2):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["zigzag_chunk"] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)


def test_k2_kernel_matches_plain(dev):
    T, d, B, W = 90, 7, 40, 60
    g = torch.Generator(device=dev).manual_seed(0)
    kind = torch.randint(0, 3, (T, 4, B), generator=g, device=dev, dtype=torch.int32)
    f = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    fill = k1.RawFill(kind, f(T, d, B), f(T, d, B), f(T, 3, B), f(T, 5, B))
    off = torch.randint(1, 20, (B,), generator=g, device=dev, dtype=torch.int32)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = pt.Skeleton(*(torch.zeros_like(a) for a in
                            k2.empty_rows(B, W, d, torch.float32, dev)))
        kind0, specs = k2.fill_specs(fill, out)
        fn(kind0, specs, off)
        outs.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sample_skeleton_on_card(dev):
    sampler = pt.ZigZag(5, pt.potentials.grad_gauss)
    build.reset_launches()
    skel = pt.sample_skeleton(sampler, 400, np.zeros((512, 5)), np.ones((512, 5)),
                              seed=0, dtype=torch.float32)
    assert (skel.n_valid == 400).all()
    assert min(build.LAUNCHES.values()) >= 1
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all()
