"""The port's coordinate-sharded ``sample_skeleton_gspmd`` against the JAX
package, float64 on the CPU.

One group of processes over gloo per mesh shape (1 chain row x 2 dim slices:
2 processes; 2 x 2: 4 processes), started once per module by a fixture;
the worker is this file's ``__main__`` (``python tests/test_torch_gspmd.py
PORT RANK WORLD N_CHAIN OUTDIR``), each process under a 300 s timeout,
writing its arrays to OUTDIR.  The family cases read them:

* for each of the seven samplers at d = 8, B = 8, 50 events, and the Zig-Zag
  on the Cauchy target (a coordinatewise device tag), the blocks of
  every process assembled into the whole ``RunResult`` equal JAX's
  ``make_fixed_event_runner`` run without a mesh (JAX's GSPMD path runs it)
  and JAX's ``sample_skeleton_gspmd`` on a ``make_mesh(4, 2)`` CPU mesh
  where the two JAX runs agree: integers, booleans, keys and
  ``transitions`` equal; ``x``, ``v``, ``t`` and every other float to
  rtol 1e-12 (atol 1e-12, which is all that binds the state's Kahan
  residue ``t_comp``: it holds the rounding of the clock's sums, below
  1e-14 here, and differs with their order);
* ``pooled_moments(mesh=)`` gives every process the moments of every
  coordinate, equal to JAX's ``pooled_moments`` at rtol 1e-12, and
  ``sample_from_skeleton_batch(mesh=)`` its block of JAX's samples;
* the chain-sharded ``sample_skeleton_sharded`` and
  ``sample_streaming_stats(mesh=)`` on these meshes run each row's chain
  shards whole in every process of the row, as JAX's ``shard_map`` over
  ``chains`` replicates over ``dim``: bit for bit the one-process runs.

XLA's CPU backend zeroes rows of some 4-device sharded JAX runs (ROADMAP
Queue 3); where JAX's mesh run differs from its runner, the runner is the
reference, as in ``tests/test_torch_parallel.py``.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine as je  # noqa: E402
from pdmpflux_tpu.core.types import EV_INIT, empty_skeleton  # noqa: E402
from pdmpflux_tpu.parallel import mesh as jmesh  # noqa: E402
from pdmpflux_tpu.parallel import sharded as jsharded  # noqa: E402
from pdmpflux_tpu_torch.parallel import distributed as tdist  # noqa: E402

RTOL = ATOL = 1e-12
F64 = torch.float64
B, D, N, SEED, N_SAMPLES = 8, 8, 50, 7, 40
SHAPES = {"1x2": 1, "2x2": 2}   # chain rows of a mesh with 2 dim slices
FAMILIES = {
    "zigzag": ("ZigZagAD", "banana", {}),
    "sticky": ("StickyZigZagAD", "gauss", {"kappa": 0.7}),
    "suzz": ("SpeedUpZigZagAD", "gauss", {}),
    "bps": ("BPSAD", "gauss", {"refresh_rate": 0.5}),
    "boomerang": ("BoomerangAD", "gauss", {"refresh_rate": 0.5}),
    "ecmc": ("ForwardECMCAD", "gauss", {}),
    "rhmc": ("RHMCAD", "gauss", {}),
    "zigzag_cauchy": ("ZigZagAD", "cauchy", {}),
}
"""Each family's constructor, potential and options.  The Zig-Zag runs on
the banana, whose gradient couples coordinates 0 and 1, so its transition
gathers the rows; the Gaussian's gradient is coordinatewise and runs on
each slice, as does the Cauchy's (its ``"cauchy"`` tag is in
``utils.potentials.COORDINATEWISE``)."""


def _samplers(fam):
    cls, pot, kw = FAMILIES[fam]
    if "kappa" in kw:
        kw = dict(kw, kappa=np.full(D, 0.7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (getattr(pf, cls)(D, getattr(pf.utils.potentials, pot), **kw),
                getattr(pt, cls)(D, getattr(pt.potentials, pot), **kw))


def _inits(fam):
    rs = np.random.default_rng(1)
    x0 = rs.normal(size=(B, D))
    if fam in ("zigzag", "sticky", "suzz", "zigzag_cauchy"):
        return x0, rs.choice([-1.0, 1.0], size=(B, D))
    v0 = rs.normal(size=(B, D))
    if fam == "ecmc":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, v0


def _zigzag():
    return pt.ZigZag(4, pt.potentials.grad_gauss)


def _chain_runs(mesh):
    """The chain-sharded drivers on ``mesh`` (or, with a mesh of the chain
    shards alone, their one-process reference)."""
    rs = np.random.default_rng(2)
    x0, v0 = rs.normal(size=(B, 4)), rs.choice([-1.0, 1.0], size=(B, 4))
    run = pt.parallel.sample_skeleton_sharded(_zigzag(), 40, x0, v0, mesh=mesh, seed=3,
                                              dtype=F64)
    stream = pt.sample_streaming_stats(_zigzag(), 30.0, x0, v0, mesh=mesh, n_samples=256,
                                       n_batches=8, seed=5, t_cap=64, grid_chunk=128,
                                       dtype=F64, device="cpu", backend="xla_stream")
    return run, stream


# --- the worker -----------------------------------------------------------

def _worker(port, rank, world, n_chain, out):
    torch.set_num_threads(1)
    assert tdist.initialize(f"127.0.0.1:{port}", world, rank)
    try:
        mesh = pt.parallel.make_mesh(n_chain, 2)
        dims = mesh.dims(D)
        arrays = {}
        for fam in FAMILIES:
            _, ts = _samplers(fam)
            x0, v0 = _inits(fam)
            run = pt.parallel.sample_skeleton_gspmd(ts, N, x0, v0, mesh=mesh, seed=SEED,
                                                    dtype=F64)
            mean, var = pt.parallel.pooled_moments(run.skeleton, ts, N_SAMPLES, mesh=mesh)
            xs = pt.parallel.sample_from_skeleton_batch(ts, N_SAMPLES, run.skeleton,
                                                        mesh=mesh)
            for rec, name in ((run.skeleton, "skel"), (run.state, "state")):
                arrays.update({f"{fam}.{name}.{f}": a.numpy() for f, a in zip(rec._fields, rec)})
            arrays.update({f"{fam}.transitions": run.transitions.numpy(),
                           f"{fam}.mean": mean.numpy(), f"{fam}.var": var.numpy(),
                           f"{fam}.samples": xs.numpy()})
        run, stream = _chain_runs(mesh)
        arrays.update({f"chain.skel.{f}": a.numpy() for f, a in zip(run.skeleton._fields,
                                                                    run.skeleton)})
        arrays["chain.transitions"] = run.transitions.numpy()
        arrays.update({f"stream.{f}": a.numpy() for f, a in zip(stream.stats._fields,
                                                                stream.stats)})
        np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"shape": mesh.shape, "cols": [dims.lo, dims.hi],
                       "shards": mesh.local_shards(), "chain_stats": run.stats,
                       "stream": [stream.events, stream.fills]}, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=list(SHAPES))
def group_run(request, tmp_path_factory):
    """Every process's arrays and metadata for one mesh shape."""
    n_chain = SHAPES[request.param]
    world = 2 * n_chain
    out = tmp_path_factory.mktemp(f"gspmd_{request.param}")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(r),
                               str(world), str(n_chain), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{request.param} workers timed out:\n" + "\n".join(outs))
    assert [p.returncode for p in procs] == [0] * world, "\n".join(outs)
    return (request.param, n_chain,
            [dict(np.load(out / f"rank{r}.npz")) for r in range(world)],
            [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)])


def _assemble(ranks, meta, key, n_chain):
    """The whole ``(B, ...)`` array of ``key`` from every process's block:
    rows of the mesh hold chains, the two slices of a row hold coordinates
    (``x``, ``v``, ``is_active`` and the samples) or equal copies (every
    other field)."""
    per = B // n_chain
    parts = []
    for row in range(n_chain):
        a, b = ranks[2 * row][key], ranks[2 * row + 1][key]
        if key.rsplit(".", 1)[-1] in ("x", "v", "is_active", "samples"):
            assert meta[2 * row]["cols"] == [0, D // 2] and meta[2 * row + 1]["cols"] == [D // 2, D]
            parts.append(np.concatenate([a, b], axis=-1))
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)   # both slices agree
            parts.append(a)
        assert a.shape[0] == per, key
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _jax_runs(fam):
    """JAX's fixed-event runner without a mesh, and its GSPMD path on a
    (4, 2) mesh of the 8 CPU devices."""
    js, _ = _samplers(fam)
    x0, v0 = _inits(fam)
    st = js.init_state_batch(x0, v0, SEED, jnp.float64)
    sk = je.record_initial(empty_skeleton(N, D, jnp.float64, batch_shape=(B,)), st, EV_INIT)
    runner = jax.jit(je.make_fixed_event_runner(js, N, N * 256))(st, sk)
    gspmd = jsharded.sample_skeleton_gspmd(js, N, x0, v0, mesh=jmesh.make_mesh(4, 2),
                                           seed=SEED, dtype=jnp.float64)
    return js, jax.device_get(runner), jax.device_get(gspmd)


def _jax_field(rec, f):
    return np.asarray(jax.random.key_data(rec.key)) if f == "key" else np.asarray(getattr(rec, f))


def _check(got, want, what):
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_gspmd_equals_jax(group_run, fam):
    shape, n_chain, ranks, meta = group_run
    js, runner, gspmd = _jax_runs(fam)
    assert all(m["shape"] == {"chains": n_chain, "dim": 2} for m in meta)
    agree = 0
    for name, want_rec, jg_rec in (("skel", runner.skeleton, gspmd.skeleton),
                                   ("state", runner.state, gspmd.state)):
        for f in want_rec._fields:
            got = _assemble(ranks, meta, f"{fam}.{name}.{f}", n_chain)
            want, jg = _jax_field(want_rec, f), _jax_field(jg_rec, f)
            _check(got, want, f"{shape} {fam} {name}.{f} vs runner")
            same = (np.isclose(jg, want, rtol=RTOL, atol=ATOL) if want.dtype.kind == "f"
                    else jg == want)
            agree += int(same.sum())
            _check(got[same], jg[same], f"{shape} {fam} {name}.{f} vs JAX gspmd")
    assert agree > 0
    for r in ranks:
        assert int(r[f"{fam}.transitions"]) == int(runner.transitions) == int(gspmd.transitions)


@pytest.mark.parametrize("fam", ["zigzag", "suzz", "rhmc"])
def test_gspmd_moments_and_samples_equal_jax(group_run, fam):
    """Linear, speed-change (coupling every coordinate) and Verlet
    (gradient on the gathered rows) flows."""
    shape, n_chain, ranks, meta = group_run
    js, runner, _ = _jax_runs(fam)
    mean, var = jsharded.pooled_moments(runner.skeleton, js, N_SAMPLES)
    for r in ranks:
        np.testing.assert_allclose(r[f"{fam}.mean"], np.asarray(mean), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r[f"{fam}.var"], np.asarray(var), rtol=RTOL, atol=ATOL)
    xs = jsharded.sample_from_skeleton_batch(js, N_SAMPLES, runner.skeleton)
    np.testing.assert_allclose(_assemble(ranks, meta, f"{fam}.samples", n_chain),
                               np.asarray(xs), rtol=RTOL, atol=ATOL)


def test_chain_sharded_drivers_on_a_dim_mesh(group_run):
    """Each row runs its chain shards whole in both of its processes: the
    one-process run of the same chain shards, bit for bit."""
    shape, n_chain, ranks, meta = group_run
    run, stream = _chain_runs(pt.parallel.make_mesh(n_chain))
    per = B // n_chain
    for r, (arr, m) in enumerate(zip(ranks, meta)):
        part = slice(r // 2 * per, (r // 2 + 1) * per)
        for f, a in zip(run.skeleton._fields, run.skeleton):
            np.testing.assert_array_equal(arr[f"chain.skel.{f}"], a[part].numpy(), err_msg=f)
        np.testing.assert_array_equal(arr["chain.transitions"], run.transitions.numpy())
        assert m["chain_stats"] == run.stats and m["shards"] == [r // 2]
        for f, a in zip(stream.stats._fields, stream.stats):
            np.testing.assert_array_equal(arr[f"stream.{f}"], a.numpy(), err_msg=f)
        assert m["stream"] == [stream.events, stream.fills]


def test_dim_mesh_needs_a_group_of_processes():
    with pytest.raises(ValueError, match="'dim' axis lays its slices over the processes"):
        pt.parallel.make_mesh(1, 2)
    run = pt.parallel.sample_skeleton_gspmd(_zigzag(), 1, np.zeros((2, 4)), np.ones((2, 4)),
                                            seed=0, dtype=F64)
    assert (run.skeleton.n_valid == 1).all() and int(run.transitions) == 0
    with pytest.raises(ValueError, match="n_sk must be positive"):
        pt.parallel.sample_skeleton_gspmd(_zigzag(), 0, np.zeros((2, 4)), np.ones((2, 4)))


def test_dim_axis_of_one_holds_every_coordinate():
    """In a process group of one, a mesh's dim axis of 1 reduces locally
    (``LOCAL``, no collective), and its run is the run without a group bit
    for bit; so is a run through a one-part ``ShardedDims``, whose every
    reduction goes through the group's collectives."""
    from pdmpflux_tpu_torch.core.dims import LOCAL, ShardedDims

    x0, v0 = np.zeros((2, 4)), np.ones((2, 4))

    def run(mesh):
        return pt.parallel.sample_skeleton_gspmd(_zigzag(), 20, x0, v0, mesh=mesh, seed=1,
                                                 dtype=F64)

    want = run(pt.parallel.make_mesh())
    assert tdist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        mesh = pt.parallel.make_mesh()
        assert mesh.shape == {"chains": 1, "dim": 1} and mesh.dims(4) is LOCAL
        got = [run(mesh)]
        mesh.dims = lambda d: ShardedDims(d, 0, 1, torch.distributed.group.WORLD)
        got.append(run(mesh))
    finally:
        torch.distributed.destroy_process_group()
    for g in got:
        for rec, ref in ((g.skeleton, want.skeleton), (g.state, want.state)):
            for f, a, b in zip(rec._fields, rec, ref):
                assert torch.equal(a, b), f
        assert int(g.transitions) == int(want.transitions)


if __name__ == "__main__":
    _worker(*map(int, sys.argv[1:5]), sys.argv[5])
