"""The port's transition engine (``pdmpflux_tpu_torch.core.engine``) against
the JAX package's XLA engine (``pdmpflux_tpu.core.engine``), float64 on the
CPU.

* Transitions: JAX's ``make_transition`` under ``jax.vmap`` runs 300
  transitions of B = 16 chains at d = 10 from a numpy-seeded state, on the
  Gaussian and the banana, for the Zig-Zag family: the Zig-Zag with scalar
  and vectorized bounds, ``grid_size=0`` and finite-difference tangents,
  the Sticky Zig-Zag with scalar and vectorized bounds, and the Speed-Up
  Zig-Zag (BPS, the Boomerang and Forward ECMC in its three jump variants:
  ``test_torch_engine_scalar.py``; RHMC: ``test_torch_rhmc.py``).  The port's batched transition
  takes every one of those 300 x 16 input states at once and must give
  JAX's next state and event: kinds, modes, counters, activity and keys
  equal, floats to rtol 1e-12 (atol 1e-12 near zero).  Each step starts
  from JAX's state, so chaotic targets (the banana) do not amplify rounding
  across steps.  Finite-difference tangents are held at rtol 1e-7
  (``test_torch_bounds.py`` says why).
  The two funnels, whose device tags hand the engine their closed forms,
  run the vectorized Zig-Zag alike.
* Velocity jumps: each family's ``velocity_jump`` on equal keys.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine as je  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core import engine as te  # noqa: E402

B, D, N_STEPS = 16, 10, 300
RTOL = ATOL = 1e-12
FD_RTOL = 1e-7
FAMILIES = {
    "zigzag_scalar": ("ZigZagAD", dict(vectorized_bound=False)),
    "zigzag_vect": ("ZigZagAD", {}),
    "zigzag_const": ("ZigZagAD", dict(grid_size=0)),
    "zigzag_fd": ("ZigZagAD", dict(AD_backend="FiniteDiff")),
    "sticky_scalar": ("StickyZigZagAD", dict(kappa=0.7, vectorized_bound=False)),
    "sticky_vect": ("StickyZigZagAD", dict(kappa=0.7)),
    "suzz": ("SpeedUpZigZagAD", {}),
    "bps": ("BPSAD", dict(refresh_rate=0.5)),
    "boomerang": ("BoomerangAD", dict(refresh_rate=0.5)),
    "ecmc_switch": ("ForwardECMCAD", {}),
    "ecmc_refresh": ("ForwardECMCAD", dict(switch=False)),
    "ecmc_normal": ("ForwardECMCAD", dict(normal=True, ran_p=True)),
}


def pair(family, pot, d=D):
    """The JAX and the port sampler of a family on a potential."""
    cls, kw = FAMILIES[family] if isinstance(family, str) else family
    if "kappa" in kw:
        kw = dict(kw, kappa=np.full(d, 0.7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the Zig-Zag's signed -> unsigned notice
        return (getattr(pf, cls)(d, getattr(pf.utils.potentials, pot), **kw),
                getattr(pt, cls)(d, getattr(pt.potentials, pot), **kw))


def initial(family, seed, Bc=B, d=D):
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(Bc, d))
    if family.startswith(("zigzag", "sticky", "suzz")):
        v0 = rs.choice([-1.0, 1.0], size=(Bc, d))
    else:
        v0 = rs.normal(size=(Bc, d))
        if family.startswith("ecmc"):
            v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, v0


def to_torch_state(st):
    """A JAX state (any leading axes, flattened to one) as the port's."""
    fields = {f: np.asarray(jax.random.key_data(st.key)) if f == "key"
              else np.asarray(getattr(st, f)) for f in st._fields}
    n = fields["t"].size
    fields = {f: a.reshape((n,) + a.shape[fields["t"].ndim:]) for f, a in fields.items()}
    return convert.state_from_numpy(fields, device="cpu")


def assert_records_equal(got, want, rtol, what):
    """Two records (states or events) with the same fields: integers,
    booleans and keys equal, floats to ``rtol`` (atol 1e-12)."""
    for f in want._fields:
        a = (np.asarray(jax.random.key_data(want.key)) if f == "key"
             else np.asarray(getattr(want, f)))
        a = a.reshape(getattr(got, f).shape)
        b = getattr(got, f).numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"{what}: {f}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=ATOL, err_msg=f"{what}: {f}")


def jax_steps(js, x0, v0, seed, n=N_STEPS):
    """JAX's engine from the numpy state: the input state, the next state and
    the event of each of ``n`` transitions, stacked ``(n, B, ...)``."""
    st = js.init_state_batch(x0, v0, seed, dtype=jnp.float64)
    tr = jax.vmap(je.make_transition(js))

    def body(c, _):
        ns, ev = tr(c)
        return ns, (c, ns, ev)

    _, out = jax.jit(lambda s: jax.lax.scan(body, s, None, length=n))(st)
    return out


def check_transitions(family, pot, seed=3):
    js, ts = pair(family, pot)
    x0, v0 = initial(family if isinstance(family, str) else family[0], seed)
    ins, outs, evs = jax_steps(js, x0, v0, seed)
    rtol = FD_RTOL if "fd" in family else RTOL
    ns, ev = te.make_transition(ts)(to_torch_state(ins))
    assert_records_equal(ns, outs, rtol, f"{family}/{pot} state")
    assert_records_equal(ev, evs, rtol, f"{family}/{pot} event")
    return np.asarray(evs.kind), np.asarray(outs.rejected)


SCALAR_FAMILIES = ("bps", "boomerang", "ecmc_switch", "ecmc_refresh", "ecmc_normal")


@pytest.mark.parametrize("pot", ["gauss", "banana"])
@pytest.mark.parametrize("family", [f for f in FAMILIES if f not in SCALAR_FAMILIES])
def test_transitions_match_jax(family, pot):
    kinds, rejected = check_transitions(family, pot)
    # the run went through the branches it claims
    assert (kinds == pt.EV_JUMP).sum() > 100
    if family.startswith("sticky"):
        assert (kinds == pt.EV_STICK).any() and (kinds == pt.EV_THAW).any()


@pytest.mark.parametrize("pot", ["funnel", "neal_funnel"])
def test_transitions_match_jax_on_the_funnels(pot):
    """The vectorized Zig-Zag on the two funnels, whose device tags give the
    engine their closed forms (``utils.potentials.LANE_POTENTIALS``, chain
    sums included) where JAX differentiates the potential: 300 teacher-forced
    transitions, as above.  The funnel starts at ``x[0]`` in [0.5, 3]."""
    js, ts = pair("zigzag_vect", pot)
    assert ts.device_potential == pot
    x0, v0 = initial("zigzag_vect", 5)
    if pot == "funnel":
        x0[:, 0] = 0.5 + np.abs(x0[:, 0])
    ins, outs, evs = jax_steps(js, x0, v0, 5)
    ns, ev = te.make_transition(ts)(to_torch_state(ins))
    assert_records_equal(ns, outs, RTOL, f"{pot} state")
    assert_records_equal(ev, evs, RTOL, f"{pot} event")
    assert (np.asarray(evs.kind) == pt.EV_JUMP).sum() > 100


@pytest.mark.parametrize("family", [f for f in FAMILIES if not f.endswith(("fd", "const"))]
                         + ["bps_gaussian"])
def test_velocity_jumps_match_jax(family):
    if family == "bps_gaussian":
        js, ts = pair(("BPSAD", dict(refresh_rate=0.5, gaussian_velocity=True)), "banana")
    else:
        js, ts = pair(family, "banana")
    Bc = 64
    x, v = initial(family, 21, Bc)
    rs = np.random.default_rng(22)
    act = rs.random((Bc, D)) < 0.7 if family.startswith("sticky") else np.ones((Bc, D), bool)
    keys = jax.random.split(jax.random.key(23), Bc)
    want = jax.vmap(js.velocity_jump)(jnp.asarray(x), jnp.asarray(v), keys, jnp.asarray(act))
    got = ts.velocity_jump(torch.as_tensor(x), torch.as_tensor(v),
                           torch.as_tensor(np.asarray(jax.random.key_data(keys)).astype(np.int64)),
                           torch.as_tensor(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not np.allclose(got.numpy(), v)  # the jump moved the velocities
