"""The port's profiling hooks (``pdmpflux_tpu_torch.utils.profiling``)
against the JAX package's contract (``tests/test_polish.py``'s profiling
cases), on the CPU: ``timed``'s keys and split, an ``annotate`` span in the
exported trace, ``trace`` writing under its ``logdir``, and
``enable_persistent_cache`` moving the kernels' build directory."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.utils import profiling as jprof  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import build  # noqa: E402
from pdmpflux_tpu_torch.utils import profiling  # noqa: E402


def test_timed_keys_and_split_match_jax():
    want = jprof.timed(lambda x: (x * x).sum(), jnp.arange(8.0), repeats=3)
    r = profiling.timed(lambda x: (x * x).sum(), torch.arange(8.0), repeats=3)
    assert set(r) == set(want)
    assert r["steady_state_s"] >= 0 and r["first_call_s"] >= 0
    assert r["compile_overhead_s"] == max(0.0, r["first_call_s"] - r["steady_state_s"])
    assert r["compile_overhead_s"] >= 0
    assert float(r["result"]) == float((np.arange(8.0) ** 2).sum())


def test_timed_walks_a_skeleton_and_dicts():
    sampler = pt.ZigZag(2, pt.potentials.grad_gauss)

    def call():
        skel = pt.sample_skeleton(sampler, 20, np.zeros(2), np.ones(2), seed=0,
                                  dtype=torch.float64, device="cpu")
        return {"skel": skel, "pair": (skel.t, [skel.x])}

    r = profiling.timed(call, repeats=1)
    assert r["result"]["skel"].t.shape == (20,)
    assert profiling._cuda_devices(r["result"]) == set()   # CPU tensors: nothing to wait on


def _trace_events(logdir):
    files = sorted(logdir.rglob("*.pt.trace.json"))
    assert files, list(logdir.rglob("*"))
    return json.loads(files[-1].read_text())["traceEvents"]


def test_annotate_span_in_exported_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("unit-test-span"):
            torch.ones(4).sum()
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "unit-test-span" in names
    with profiling.annotate("no-trace-active"):   # a no-op outside a trace
        pass


def test_trace_writes_under_logdir(tmp_path, capsys):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), create_perfetto_link=True) as prof:
        torch.ones(4).sum()
    assert prof is not None
    written = [p for p in logdir.rglob("*") if p.is_file()]
    assert written and all(p.stat().st_size > 0 for p in written)
    assert str(written[0]) in capsys.readouterr().out


def test_enable_persistent_cache_moves_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    profiling.enable_persistent_cache(str(tmp_path / "kernels"))
    assert build.BUILD_DIR == tmp_path / "kernels"
