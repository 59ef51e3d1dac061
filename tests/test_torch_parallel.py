"""The port's multi-device layer (``pdmpflux_tpu_torch.parallel``) against
the JAX package's, float64 on the CPU.

* The package surface: the port's root, ``parallel`` and ``utils`` names
  are JAX's (nothing is owed any more: ``OWED`` is empty), plus the port's
  own (``PORT_ONLY``).
* ``sample_skeleton_sharded`` on a 4-shard CPU mesh against JAX's on a
  4-device CPU mesh (``tests/conftest.py`` makes 8), in both modes: each
  shard on the transition engine, as JAX runs its XLA engine off the TPU;
  integers and transition counts equal, floats and ``ar_sum`` to rtol
  1e-12 (rounding order only), the batch-divisibility error JAX's text.
* Two processes over gloo (the worker is this file's ``__main__``, each run
  under a 150 s timeout): the skeleton, state, transitions, stats and
  ``pooled_moments(mesh=)`` equal the single-process run of the whole batch
  bit for bit, ``host_all_gather_stats`` sums the processes' stats, a
  sharded resume is bit for bit, and streaming with the mesh equals
  streaming without one.
* ``sample_streaming_stats(mesh=)`` in one process equals the run without a
  mesh bit for bit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.parallel import mesh as jmesh  # noqa: E402
from pdmpflux_tpu.parallel import sharded as jsharded  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.parallel import distributed as tdist  # noqa: E402
from pdmpflux_tpu_torch.parallel import sharded as tsharded  # noqa: E402

RTOL = ATOL = 1e-12
F64 = torch.float64
# names the port does not have yet: none
OWED = {"root": set(), "parallel": set(), "utils": set()}
# the port's root also exports its chain-batch helpers and potentials, which
# JAX reaches as pf.parallel.* and pf.utils.potentials, and its numpy
# converters (convert), which JAX needs no counterpart of
PORT_ONLY = {"root": {"pooled_moments", "sample_from_skeleton_batch", "potentials", "convert"},
             "parallel": set(), "utils": set()}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("where", ["root", "parallel", "utils"])
def test_package_surface_matches_jax(where):
    jmod = {"root": pf, "parallel": pf.parallel, "utils": pf.utils}[where]
    tmod = {"root": pt, "parallel": pt.parallel, "utils": pt.utils}[where]
    assert _public(tmod) - PORT_ONLY[where] == _public(jmod) - OWED[where]
    assert tmod.__all__ == [n for n in jmod.__all__ if n not in OWED[where]]
    if where == "root":
        assert pt.__version__ == pf.__version__


def _inits(B, d, seed=0):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(B, d)), rs.choice([-1.0, 1.0], size=(B, d))


def _jax_sharded(n_or_T, x0, v0, shards):
    return jsharded.sample_skeleton_sharded(pf.ZigZag(x0.shape[1], lambda x: x), n_or_T, x0, v0,
                                            mesh=jmesh.make_mesh(shards, 1), seed=3,
                                            dtype=jnp.float64, init_capacity=64)


@pytest.mark.parametrize("n_or_T", [80, 9.0])
def test_sharded_matches_jax_sharded(n_or_T):
    """Against JAX on 4 devices.  XLA's CPU backend zeroes a row of JAX's
    sharded compaction here (chain 2, row 2 of ``x`` at ``n_or_T=80``; the
    merge defect of ROADMAP Queue 3): where JAX's 4-device run differs from
    its 1-device run, the 4-device entry must be that zero, and the 1-device
    run's value is the reference."""
    B, d = 8, 4
    x0, v0 = _inits(B, d)
    want, want1 = _jax_sharded(n_or_T, x0, v0, 4), _jax_sharded(n_or_T, x0, v0, 1)
    ts = pt.ZigZag(d, pt.potentials.grad_gauss)
    mesh = pt.parallel.make_mesh(4)
    assert mesh.shape[pt.parallel.CHAIN_AXIS] == 4
    got = pt.parallel.sample_skeleton_sharded(ts, n_or_T, x0, v0, mesh=mesh, seed=3,
                                              dtype=F64, init_capacity=64)
    g = convert.skeleton_to_numpy(got.skeleton)
    for f in want.skeleton._fields:
        a, a1, b = (np.asarray(getattr(want.skeleton, f)), np.asarray(getattr(want1.skeleton, f)),
                    g[f])
        assert a.shape == a1.shape == b.shape and a.dtype == b.dtype, f
        zeroed = (a != a1) & (a == 0)
        assert ((a == a1) | zeroed).all(), f
        a = np.where(zeroed, a1, a)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(got.transitions.numpy(), np.asarray(want.transitions))
    np.testing.assert_array_equal(convert.state_to_numpy(got.state)["key"],
                                  np.asarray(jax.random.key_data(want.state.key)))
    for k, v in want.stats.items():
        assert got.stats[k] == pytest.approx(float(v), rel=RTOL), k
    # the per-chain streams are the unsharded engine run's
    one = pt.sample_skeleton(ts, n_or_T, x0, v0, seed=3, dtype=F64, device="cpu",
                             backend="xla_stream", init_capacity=64)
    W = one.t.shape[1]
    for f, a, b in zip(one._fields, got.skeleton, one):
        assert torch.equal(a if f == "n_valid" else a[:, :W], b), f


def test_sharded_errors_match_jax():
    x0, v0 = _inits(6, 3)
    with pytest.raises(ValueError) as ej:
        jsharded.sample_skeleton_sharded(pf.ZigZag(3, lambda x: x), 20, x0, v0,
                                         mesh=jmesh.make_mesh(4, 1))
    with pytest.raises(ValueError) as et:
        pt.parallel.sample_skeleton_sharded(pt.ZigZag(3, pt.potentials.grad_gauss), 20,
                                            x0, v0, mesh=pt.parallel.make_mesh(4))
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="must divide the group's 1 processes"):
        pt.parallel.make_mesh(1, 2)   # a dim axis lies over processes (test_torch_gspmd.py)
    x0, v0 = _inits(4, 3)
    with pytest.warns(UserWarning, match="only supported in event-count mode"):
        run = pt.parallel.sample_skeleton_sharded(
            pt.ZigZag(3, pt.potentials.grad_gauss), 0.0, x0, v0, checkpoint_path="unused.npz")
    assert (run.skeleton.n_valid == 1).all() and run.skeleton.t.shape == (4, 2)
    assert not os.path.exists("unused.npz")


STREAM = dict(n_samples=512, n_batches=8, seed=5, t_cap=64, grid_chunk=256, dtype=F64,
              device="cpu")


def _stream(mesh=None, **kw):
    x0, v0 = _inits(8, 3, seed=4)
    return pt.sample_streaming_stats(pt.ZigZag(3, pt.potentials.grad_gauss), 60.0, x0, v0,
                                     mesh=mesh, **STREAM, **kw)


@pytest.mark.parametrize("shards,backend", [(2, "xla_stream"), (1, "auto")])
def test_streaming_with_mesh_equals_without(shards, backend):
    """Two shards on the engine (per-chain streams), or one shard on the
    kernel route (the chunk kernel's plain version): the run without a mesh,
    bit for bit."""
    want = _stream(backend=backend)
    got = _stream(pt.parallel.make_mesh(shards), backend=backend)
    assert (got.events, got.fills) == (want.events, want.fills) and want.fills > 2
    for a, b in zip(got.stats, want.stats):
        assert torch.equal(a, b)
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)


# --- two processes --------------------------------------------------------

B2, D2, N2, SEED2 = 8, 3, 120, 11


def _two_process_runs(mesh, out=None):
    """What each process of the two-process test computes; with ``out`` the
    checkpoint rehearsal too."""
    x0, v0 = _inits(B2, D2, seed=9)

    def run(**kw):
        return pt.parallel.sample_skeleton_sharded(
            pt.ZigZag(D2, pt.potentials.grad_gauss), N2, x0, v0, mesh=mesh, seed=SEED2,
            dtype=F64, **kw)

    res = {"run": run()}
    if out is not None:
        path = os.path.join(out, "ck.npz")
        os.environ["PDMPFLUX_FAIL_AFTER_FILLS"] = "2"
        try:
            run(checkpoint_path=path, checkpoint_every=1)
        except RuntimeError as e:
            assert "fault injection" in str(e)
        del os.environ["PDMPFLUX_FAIL_AFTER_FILLS"]
        res["resumed"] = run(checkpoint_path=path, checkpoint_every=1)
    res["stream"] = _stream(mesh, backend="xla_stream")
    return res


def _worker(port, rank, out):
    torch.set_num_threads(1)
    os.environ["PDMPFLUX_DEVICE_BYTES"] = "1000"  # 64-row fills: several per run
    assert tdist.initialize(f"127.0.0.1:{port}", 2, rank)
    try:
        mesh = tdist.global_mesh()
        res = _two_process_runs(mesh, out)
        run = res["run"]
        sampler = pt.ZigZag(D2, pt.potentials.grad_gauss)
        mean, var = pt.parallel.pooled_moments(run.skeleton, sampler, 50, mesh=mesh)
        local = tsharded._skeleton_stats(run.skeleton)
        arrays = {f"skel.{f}": a.numpy() for f, a in zip(run.skeleton._fields, run.skeleton)}
        arrays.update({f"resumed.{f}": a.numpy()
                       for f, a in zip(run.skeleton._fields, res["resumed"].skeleton)})
        arrays.update({f"state.{f}": a.numpy() for f, a in zip(run.state._fields, run.state)})
        arrays.update({f"stream.{f}": a.numpy() for f, a in zip(res["stream"].stats._fields,
                                                                res["stream"].stats)})
        np.savez(os.path.join(out, f"rank{rank}.npz"), transitions=run.transitions.numpy(),
                 mean=mean.numpy(), var=var.numpy(), **arrays)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"stats": run.stats, "summed": tdist.host_all_gather_stats(local),
                       "slice": tdist.process_local_chain_slice(B2),
                       "shards": mesh.shape[pt.parallel.CHAIN_AXIS],
                       "stream": [res["stream"].events, res["stream"].fills]}, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run_equals_one_process(tmp_path, monkeypatch):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(r),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("two-process workers timed out:\n" + "\n".join(outs))
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)

    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", "1000")
    one = _two_process_runs(pt.parallel.make_mesh(2))
    whole = _two_process_runs(pt.parallel.make_mesh(1))["run"]
    ref = one["run"]
    for f, a, b in zip(ref.skeleton._fields, ref.skeleton, whole.skeleton):
        assert torch.equal(a, b), f   # two shards in one process: the whole batch's run
    sampler = pt.ZigZag(D2, pt.potentials.grad_gauss)
    mean, var = pt.parallel.pooled_moments(whole.skeleton, sampler, 50)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    meta = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    half = B2 // 2
    for r in range(2):
        part = slice(r * half, (r + 1) * half)
        for f, a in zip(ref.skeleton._fields, ref.skeleton):
            np.testing.assert_array_equal(got[r][f"skel.{f}"], a[part].numpy(), err_msg=f)
            np.testing.assert_array_equal(got[r][f"resumed.{f}"], a[part].numpy(), err_msg=f)
        for f, a in zip(ref.state._fields, ref.state):
            np.testing.assert_array_equal(got[r][f"state.{f}"], a[part].numpy(), err_msg=f)
        for f, a in zip(one["stream"].stats._fields, one["stream"].stats):
            np.testing.assert_array_equal(got[r][f"stream.{f}"], a.numpy(), err_msg=f)
        np.testing.assert_array_equal(got[r]["transitions"], ref.transitions.numpy())
        np.testing.assert_array_equal(got[r]["mean"], mean.numpy())
        np.testing.assert_array_equal(got[r]["var"], var.numpy())
        assert meta[r]["stats"] == ref.stats == whole.stats
        assert meta[r]["slice"] == [r * half, (r + 1) * half] and meta[r]["shards"] == 2
        assert meta[r]["stream"] == [one["stream"].events, one["stream"].fills]
        for k in ("events", "rejected", "errored_bound", "hitting_horizon"):
            assert meta[r]["summed"][k] == ref.stats[k], k
        assert meta[r]["summed"]["ar_sum"] == pytest.approx(ref.stats["ar_sum"], rel=RTOL)
    assert len(ref.transitions) == 2 and ref.transitions.min() >= 3 * 64  # several fills


def test_single_process_helpers():
    assert tdist.initialize(None, 1, 0) is False and tdist.initialize() is False
    assert tdist.process_local_chain_slice(10) == (0, 10)
    stats = {"events": 3, "ar_sum": 0.5}
    assert tdist.host_all_gather_stats(stats) is stats
    mesh = tdist.global_mesh()
    assert mesh.shape == {"chains": 1, "dim": 1} and not mesh.distributed
    assert pt.parallel.chain_sharding(pt.parallel.make_mesh(4), 8) == [(0, 2), (2, 4), (4, 6),
                                                                       (6, 8)]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
