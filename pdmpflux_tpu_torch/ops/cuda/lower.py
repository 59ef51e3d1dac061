"""Lower a gradient of the user's own into the CUDA chunk kernels.

The port of ``_hoist_consts`` and ``convert_grad``
(``pdmpflux_tpu/ops/pallas/driver.py:421-470``): JAX traces the user's
gradient to a jaxpr, hoists its constants and evaluates it inside the Pallas
kernel body.  Here the per-chain gradient (``sampler.grad_U``: the user's
gradient, or the ``torch.func.grad`` an ``*AD`` constructor builds) is traced
with ``make_fx`` on a ``(d,)`` example of the run's dtype, decomposed to core
aten ops, and interpreted into a small IR from which two things are emitted:

* a CUDA C++ header defining ``UserPotential<T>``, the device potential id 7
  of ``csrc/pdmp_common.cuh`` (``with_potential``), which every chunk kernel
  (K1, K6, K3/K5, K4) takes once ``ops/cuda/build.user_library`` has compiled
  the kernel's source with it;
* the same arithmetic as a chain-minor torch pair ``(grad, grad_jvp)`` on
  ``(d, B)`` tensors: the plain version of the generated potential, which the
  plain chunk kernels run and the card's kernels are held against.

The IR.  A value of the trace is one of:

* a constant (no dependence on ``x``): computed with torch while lowering, in
  the run's dtype; a non-uniform vector constant (a user's scales, a data
  set's labels) is hoisted into the potential's parameter vector
  (``Lowered.params``), read as ``prm[k + i]`` at index ``i``, as the
  ``aniso`` tag reads its scales;
* a chain value: one scalar per chain, an expression of literals, parameters,
  fixed coordinates of the point (``x[0]``, ``x[1]``, and ``x[k]`` for any
  other ``k``), sums (reductions) and nothing else;
* an index table: a constant integer array (a gather's index, a
  scatter-add's CSR) hoisted into the parameters, exact in the run's dtype
  (every entry below 2^24, a float32 mantissa), read as ``(int)prm[T +
  i]``;
* a vector of pieces: positions ``[a, b)`` each either a chain value or a lane
  expression evaluated at index ``i = p + off`` of the position ``p``, of
  the point's own ``y_i = x_i + v_i t``, its neighbours at fixed offsets
  (``y_{i+k}``, from slices such as ``x[1:] - x[:-1]``), coordinates read
  through an index table (``y_{T[i + k]}``: a gather ``v[idx]``,
  ``index_select``, ``gather`` or ``take`` at a constant 1-D index, whose
  row ``r`` is ``v``'s expression at position ``idx[r]``, its parameters a
  gathered hoisted copy), parameters, chain values, a stage's element (at
  the same index, at an affine row ``(i - c) / s``, or through an index
  table: :data:`_PRODUCT_LEAVES`) and a scatter-add's element (below).
  Pieces read at different offsets are rebased onto one index (a product's
  element keeps its own where it can), their reads becoming neighbours and
  a product's rows ``i - c``; a read outside ``[0, d)`` or past a
  product's rows is refused.  A vector lies in an index space: the
  coordinates, or the rows of a data vector (``X @ y`` for an ``(n, d)``
  constant ``X``, ``n != d``); coordinates read beside a data vector's rows
  are read at the row's index (``mu + Z @ gamma + s * x[:J]``: row ``j``
  reads coordinate ``j``), and a data vector's rows placed at the
  coordinates are read at the coordinate's row (``X.T @ r`` into a slice of
  x).
  ``slice``, ``select``, ``slice_scatter``, ``select_scatter``, ``cat``/
  ``stack``, ``roll`` (``cat(v[d - s:], v[:d - s])``) and ``where`` on a
  constant mask (``torch.func.grad`` of ``x[0]`` emits ``where(arange ==
  0, ...)``) move pieces about; ``flip`` turns each piece around, its reads
  of ``x`` becoming reads of coordinate ``c - i`` (``ya`` with stride -1)
  and its parameters a reversed copy, a piece that reads a stage or a
  table read at its reversed indices as a gather reads it; a vector held as
  a column or a row
  (``unsqueeze``, ``permute``, a product's batch views) is the same vector;
* a matrix (:class:`Mat`): a value with two dimensions past 1 whose shorter
  one, ``K <=`` :data:`KMAX`, is unrolled at lowering time into ``K``
  vectors (a mixture's components ``x[None, :] - MU``, a softmax's classes,
  ``x.reshape(K, p)``'s rows as slices, ``x.reshape(p, K)``'s columns as
  strided reads ``x[K r + k]``); an elementwise op acts on each, a
  reduction along the short axis folds them at lowering time, along the
  long one makes a stage of each; a ``flip`` or a ``roll`` along the short
  axis relabels its vectors, along the long one moves each vector's
  pieces (the periodic lattice of a phi^4 action); ``mm`` of a constant
  matrix with it makes a product of each column (or row), its backward
  ``X.T @ G`` too, and where such a matrix is flattened into the
  coordinates, coordinate ``i`` reads product ``i % K``'s row ``i / K``
  (``(n, K)``) or product ``i / p``'s row ``i % p`` (``(K, p)``).

Stages.  Sums, maxes, products and running sums are stages, kept in trace
order: a sum
or a max over an index space of pieces (a max's value and tangent those
of the first index that attains it; at most :data:`KMAX` chain values,
such as the bimodal target's ``stack([a, b])``, fold at lowering time
instead), and a product ``M u`` of a constant ``(r, c)`` matrix
(``mv``, ``mm``/``bmm`` with a column or a row, their ``add`` forms,
``einsum``, ``linear`` and ``matmul`` as they trace) with a vector of the
chain, from the coordinates or a data vector's rows to the coordinates
(``A @ y``) or to other data rows (``X @ y``, ``X.T @ s``, read at the
coordinates where placed there), and a running sum over the coordinates
(``cumsum``, a ``"prefix"`` scan; ``flip(cumsum(flip(u)))``, ``cumsum``'s
backward, a ``"suffix"`` scan of ``u``: a flip of a vector that reads a
stage is a :class:`Rev`, which ``cumsum`` and a second flip read as such
and any other op as the flipped vector), a product with the triangular
matrix of ones that is never hoisted
(``Product.scan``).  A matrix is hoisted as it lies in memory, row- or
column-major, so ``X`` and ``X.T`` share one block.  A stage may read
earlier stages.  Products and running sums are linear, so the tangent of
``M u`` is ``M du``.

The lowering adds forward-mode tangents (a dual-number rule per op) to give
the kernels' pair ``(g_i, (H v)_i)`` from the gradient alone, the tangent of
``y_j`` being the velocity ``v_j`` of the same coordinate.  Every kernel
hands the potential an accessor ``yw(j, y, w)`` of the point it evaluates
(``Pot::at``, ``Pot::sums``, ``Pot::fill``): a neighbour or a fixed
coordinate past 1 is read through it, so such a read adds no context.

Where the stages are formed.  A product whose input has degree at most 1
in ``t`` (``x``, ``A (x - mu)``, ``X b``, an earlier such product's output:
``y - s cumsum(z)``, a residual ``y - alpha[county] - X b`` over data rows,
a scatter-add of such rows) is affine along K1's and K3/K5's flows, so
those kernels form it once per
transition (``Lowered.trans``, ``UserPotential::form``, in stage order, the
lanes meeting at a ``__syncwarp`` before a stage that reads an earlier
one): the chain's lanes split its rows and add each in column order (a
running sum: each lane adds a run of coordinates in order, then the runs'
totals before it by shuffle in run order, :func:`ordered_scan` with the
lanes' count), ``c0 = M u(x)`` and ``c1 = M du(x; v)`` at the transition's
start, and every point reads
element ``r`` as ``c0[r] + t c1[r]`` with tangent ``c1[r]`` (the
Boomerang's elliptic flow: ``a cos t + c1 sin t + mc`` and ``c1 cos t - a
sin t``, ``a = c0 - mc``, ``mc = M u(0)`` hoisted into the parameters),
through the point's accessor (``yw.prod``) at any row.  Every other stage
is formed at the point.  A max is not a moment, so K1 and K6 form any stage
that reads one at each point.  K3/K5 and K4 form it at every point they
evaluate, one lane walking the chain (``UserPotential::sums``): a
coordinate-space input in the lane's local memory, a data vector streamed
row by row; a product from the coordinates to data rows is formed row by
row where it is read (``Lowered.inline``: at a data loop's own row, or at
any other row from its input, which the ``Sums`` keep where the
coordinates' gradient reads it, :meth:`_Emit.row`), every other one in a
slot of the ``Sums``; every sum, every product element and
every running sum added in index order, as the plain version's
``ordered_sum``, ``ordered_matvec`` and ``ordered_scan`` add, so the two
agree bit for bit where the kernel rounds as torch does (``-fmad=false``).
K1 and K6 reduce sums of summands of
degree at most 2 in ``t`` that read their own coordinate and coordinates 0
and 1 once per transition as chain moments, extrapolated along the linear
flow in truncated Taylor arithmetic of order 2 (exact there); a gradient
with any other stage (K6: any product) is a point potential for them too:
K1's lane forms the stages at each point it evaluates, as K3 does, and
K6's block forms them together (``UserPotential::fill``: each stage's
positions across the threads, products' inputs and outputs in shared
memory, each complete behind a barrier before any thread reads its rows
elsewhere, sums by a two-level reduction, maxes by one of (value, tangent,
index) whose ties take the lower index, running sums by a block scan with
a barrier between the warps' totals and their reads).  The plain version
forms the per-transition products as the kernels do (``Lowered.along``).

Scatter-adds.  The backward of a gather, ``index_put``/``put`` with
``accumulate=True``, ``scatter_add`` and ``index_add`` of a vector of ``n``
rows at a constant index into the coordinates (or a slice of them, as
``x[:J][county]``'s), is a ``seg`` node: coordinate ``i``'s element adds the
rows ``r`` with ``idx[r] = i``.  The rows sorted stably by target and their
segments' starts (the index's CSR) are index tables; the kernels walk
coordinate ``i``'s segment where the element is read, each row's term
evaluated at that row (its own reads through ``yw``), in increasing ``r``,
the value and its tangent in one walk (``_Emit.seg``), as the plain
version's :func:`ordered_segment_sum` adds.  A row may read stages (a
varying intercept's residual ``y - alpha[county] - X b``), each where the
kernel keeps it.  A segment walk is no stage and no context: it adds
nothing to a lane's bytes.  A sum over the rows whose summand reads
gathered coordinates is a sum over a data vector (a point sum on K1/K6: it
is no chain moment); a scatter-add of rows of degree at most 1 has degree
1, but a sum of one is no chain moment either.

A gradient that reads coordinates other than its own (neighbours, fixed
coordinates, a flip's ``c - i``, a gather's or a segment's rows) sets
``reads_others``: K6 then publishes the chain's values to every warp before
it reads them.

Anything else (a product of two vectors of the chain, a matrix that depends
on ``x``, ``cumprod``, ``sort``, convolutions, one element of a product read
as a chain value, a running sum of a matrix or of a data vector, a 2-D
index array, an index that depends on ``x``, a write at an index that does
not add (``scatter``, ``index_put`` without ``accumulate``), a scatter into
more than the ``d`` coordinates, a gather, a flip or a scatter-add of a
scatter-add's output, a flattened matrix's parameters moved to another
offset, a short axis past :data:`KMAX`, a branch on a value of ``x``, an op
outside the set) raises
:class:`LoweringError` naming the op and its node, before any build or
launch.  The result is cached on the sampler by (kernel, d, dtype).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ...core.dims import ordered_matvec, ordered_sum

USER_POTENTIAL = "user"
"""``ChunkConfig.device_potential`` of a lowered gradient."""
USER_ID = 7
"""The potential id of ``UserPotential`` in ``csrc/pdmp_common.cuh``."""

SOURCES = {"zigzag": "zigzag_chunk.cu", "sticky": "sticky_chunk.cu",
           "suzz": "suzz_chunk.cu", "bps": "scalar_chunk.cu",
           "boomerang": "scalar_chunk.cu", "ecmc": "scalar_chunk.cu"}
"""The chunk source that runs each kernel (K1, K6, K4, K3, K3, K5)."""
MOMENT_KERNELS = ("zigzag", "sticky")
"""Kernels that reduce chain moments once per transition (K1, K6)."""
TRANSITION_KERNELS = ("zigzag", "bps", "boomerang", "ecmc")
"""Kernels whose flow (linear, or the Boomerang's elliptic one) keeps a
product of an affine input affine in ``t``, so that they form it once per
transition (K1, K3, K5)."""

LANE_BYTES = 4096
"""Most bytes of per-point context (``Lowered.lane_bytes``: sums, the
outputs of products formed at the point, their inputs) one lane of K1,
K3/K5 or K4 keeps at a point; products formed once per transition are not
counted.  From ``chip_ab.py --lane-context`` on the H100, then a dense
quadratic form's per-point products: 4 KB (K3) and 6 KB (K1) ran at 2.1 ps
per operation, 16 KB on K3 at 29 ps and 48 KB on K1 at 47 ps (14-23x).
ptxas's stack frame runs 2.3-3.4x the count, and the card reserves that
frame for every thread it can hold (30 GB at 96 KB counted on K1)."""

INF = 1 << 20  # the degree in t of a summand that is not a polynomial
KMAX = 16
"""Longest short axis of a value with two dimensions past 1 (a mixture's
components, a softmax's classes, a view of x as a ``(p, K)`` matrix): its
``K`` vectors are unrolled at lowering time; a longer one is refused."""
MAX_RUNS = 4   # a constant vector of more runs of equal values is hoisted
HINT = ("run it on the transition engine with backend='xla_stream', or with "
        "device='cpu'")


class LoweringError(ValueError):
    """A gradient the CUDA chunk kernels cannot evaluate."""


class _FarRead(Exception):
    """A read of one element of a product (``Graph.pin``)."""


def _refuse(why: str) -> LoweringError:
    return LoweringError(f"this gradient cannot be lowered into the CUDA chunk kernels: "
                         f"{why}; {HINT}")


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

class Node:
    """One interned IR operation.  ``lane``: depends on the index of its
    vector (``y``, ``w`` and their neighbours ``yo``/``wo`` at offset
    ``attr``, a product's element or a parameter read there); ``fixed``:
    reads a parameter at ``i / K`` (``prmd``: such an expression cannot
    move to another offset); ``own_row``: reads a product's element at its
    own index (``mv``: a vector of pieces keeps such a piece's offset and
    moves the others); ``deg``: degree in ``t`` along the linear flow (``INF``
    past a polynomial); ``boolean``: a comparison's value; ``space``: the
    index space its lane reads (``"c"`` the coordinates, an int ``n`` the
    rows of a data vector, None for none, ``"mixed"`` for rows of two
    lengths).  A scatter-add's rows are read at their own indices: they
    make it neither ``fixed`` nor ``own_row``."""

    __slots__ = ("op", "args", "attr", "id", "lane", "fixed", "own_row", "deg", "boolean",
                 "space")

    def __init__(self, op, args, attr, nid, space=None, affine=False):
        self.op, self.args, self.attr, self.id = op, args, attr, nid
        self.lane = op in _LANE_LEAVES or op in ("sel", "seg") or any(a.lane for a in args)
        inner = () if op == "seg" else args
        self.fixed = op in _FIXED_LEAVES or any(a.fixed for a in inner)
        self.own_row = op in ("mv", "dmv") or any(a.own_row for a in inner)
        self.boolean = op in _BOOL_OPS or (op == "lit" and isinstance(attr, bool)) or (
            op == "where" and args[1].boolean) or (op == "sel" and args[0].boolean)
        self.deg = _degree(op, args, affine)
        self.space = space

    def text(self) -> str:
        """The expression as a formula (error messages)."""
        if self.op == "lit":
            return repr(self.attr)
        if self.op in ("prm", "prmk"):
            return f"prm[{self.attr}{' + i' if self.op == 'prm' else ''}]"
        if self.op in ("red", "dred"):
            return f"{'d' if self.op == 'dred' else ''}sum_{self.attr}"
        if self.op in ("mv", "dmv"):
            return f"{'d' if self.op == 'dmv' else ''}(M{self.attr} u)_i"
        if self.op in ("yo", "wo"):
            return f"{'x' if self.op == 'yo' else 'v'}_(i{self.attr:+d})"
        if self.op in ("yk", "wk"):
            return f"{'x' if self.op == 'yk' else 'v'}_{self.attr}"
        if self.op in ("ya", "wa"):
            return f"{'x' if self.op == 'ya' else 'v'}_({self.attr[0]} i{self.attr[1]:+d})"
        if self.op in ("yg", "wg"):
            return f"{'x' if self.op == 'yg' else 'v'}_(T{self.attr[0]}[i{self.attr[2]:+d}])"
        if self.op == "seg":
            return (f"scatter_T{self.attr[0]}[i{self.attr[5]:+d}]("
                    f"{', '.join(a.text() for a in self.args)})")
        if self.op in ("mvx", "dmvx"):
            m, st, c = self.attr
            return f"{'d' if self.op == 'dmvx' else ''}(M{m} u)_((i{-c:+d}) / {st})"
        if self.op in ("mvg", "dmvg"):
            m, t, _, k = self.attr
            return f"{'d' if self.op == 'dmvg' else ''}(M{m} u)_(T{t}[i{k:+d}])"
        if self.op == "prmd":
            return f"prm[{self.attr[0]} + i / {self.attr[1]}]"
        if self.op == "sel":
            return f"sel_(i % {self.attr})({', '.join(a.text() for a in self.args)})"
        if not self.args:
            return {"y": "x_i", "w": "v_i", "y0": "x_0", "w0": "v_0", "y1": "x_1",
                    "w1": "v_1"}[self.op]
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">", "ge": ">=",
               "lt": "<", "le": "<=", "eq": "==", "ne": "!="}.get(self.op)
        if sym:
            return f"({self.args[0].text()} {sym} {self.args[1].text()})"
        if self.op == "pow":
            return f"{self.args[0].text()}**{self.attr!r}"
        return f"{self.op}({', '.join(a.text() for a in self.args)})"


_LANE_LEAVES = {"y", "w", "yo", "wo", "ya", "wa", "yg", "wg", "prm", "prmd", "mv", "dmv",
                "mvx", "dmvx", "mvg", "dmvg"}
_FIXED_LEAVES = {"prmd"}
_FAR = {"yo", "wo", "yk", "wk", "ya", "wa", "yg", "wg"}
"""Reads of a neighbour (``yo``/``wo`` at offset ``attr``), of a fixed
coordinate past 1 (``yk``/``wk`` at ``attr``), of coordinate ``s i + c``
(``ya``/``wa`` at ``attr = (s, c)``: a column of a view of x as a matrix,
or with ``s = -1`` a flip) or of coordinate ``T[i + k]`` of a constant
index table ``T`` of ``n`` entries (``yg``/``wg`` at ``attr = (T, n, k)``,
``T`` the table's offset in the parameters: a gather ``x[idx]``), through
the kernel's accessor ``yw``."""
_PRODUCT_LEAVES = {"mv", "dmv", "mvx", "dmvx", "mvg", "dmvg"}
"""Reads of a stage's element (a product's, or a running sum's): at the
index (``mv``), at row ``(i - c) / s`` (``mvx`` at ``attr = (m, s, c)``: a
stage's output moved to another offset, ``s = 1``, flipped, ``s = -1``, or
its rows placed where a matrix of products is flattened into the
coordinates) or at row ``T[i + k]`` of a constant index table ``T`` of
``n`` entries (``mvg`` at ``attr = (m, T, n, k)``: a gather of a stage's
output, ``(A @ x)[idx]``, ``alpha[county]``).  One read at an index
computed from ``i``: every kernel reads the stage where it lies (the
per-transition values, a lane's slot, K6's shared memory) at that row, or
forms the row there (:meth:`_Emit.row`)."""
_FIRST = {"y0", "w0", "y1", "w1"}
_OTHERS = _FAR | _FIRST | {"seg"}
"""Every read of a coordinate other than the evaluated one (a scatter-add's
segment walk reads its rows' coordinates)."""
_BOOL_OPS = {"gt", "ge", "lt", "le", "eq", "ne", "not", "and", "or"}
_LINEAR = {"add", "sub", "neg"}


def _degree(op, args, affine=False):
    """Degree in ``t`` of ``op`` on ``args``; ``affine``: a product whose
    input is affine in the point (``Graph.mv_affine``), itself affine,
    ``c0 + t c1``, its tangent constant."""
    if op in ("y", "y0", "y1", "yo", "yk", "ya", "yg"):
        return 1
    if affine and op in _PRODUCT_LEAVES:
        return 0 if op[0] == "d" else 1
    if op == "seg":  # linear in its rows: affine where they are
        return max((a.deg for a in args), default=0) if all(a.deg <= 1 for a in args) else INF
    if op in ("red", "dred", "sel") or op in _PRODUCT_LEAVES:
        return INF
    if not args or all(a.deg == 0 for a in args):
        return 0
    if op in _LINEAR:
        return max(a.deg for a in args)
    if op == "mul":
        return min(INF, args[0].deg + args[1].deg)
    if op == "div" and args[1].deg == 0:
        return args[0].deg
    return INF


class Graph:
    """The IR's nodes, interned, so that a subexpression is one node wherever
    it appears (and is computed once by each emitter); ``mk`` folds an op on
    literals (computed in the run's dtype, so that both emitters read the one
    rounded value), ``where`` on a literal condition, ``x + 0``, ``x - 0``,
    ``x * 1`` and ``x / 1``."""

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype
        self.nodes: Dict[tuple, Node] = {}
        self.mv_space: Dict[int, object] = {}  # product -> its output's index space
        self.mv_affine: set = set()  # products of an input affine in the point
        self.tables: Dict[int, torch.Tensor] = {}  # an index table's offset -> its entries
        self.pairs: Dict[int, Node] = {}  # a scatter's node id -> its tangent's (one walk)

    def mk(self, op, *args, attr=None) -> Node:
        folded = self._fold(op, args, attr)
        if folded is not None:
            return folded
        key = (op, tuple(a.id for a in args),
               float.hex(attr) if isinstance(attr, float) else attr)
        node = self.nodes.get(key)
        if node is None:
            node = self.nodes[key] = Node(op, args, attr, len(self.nodes),
                                          self._space(op, args, attr),
                                          op in _PRODUCT_LEAVES and _stage_of(op, attr)
                                          in self.mv_affine)
        return node

    def _space(self, op, args, attr):
        if op in ("y", "w", "yo", "wo", "ya", "wa", "prmd", "seg"):
            return "c"
        if op in ("mv", "dmv"):
            return self.mv_space[attr]
        spaces = {a.space for a in args if a.space is not None}
        if len(spaces) == 2 and "c" in spaces:
            # coordinates read at a data row's index: the coordinate there (through yw)
            spaces.discard("c")
        return "mixed" if len(spaces) > 1 else (spaces.pop() if spaces else None)

    def _fold(self, op, args, attr):
        if not args:
            return None
        lits = [a.attr if a.op == "lit" else None for a in args]
        if op == "where" and lits[0] is not None:
            return args[1] if lits[0] else args[2]
        if all(c is not None for c in lits) and op in _TORCH:
            vals = [torch.tensor(c, dtype=torch.bool if isinstance(c, bool) else self.dtype)
                    for c in lits]
            out = _TORCH[op](*vals, attr)
            return self.lit(bool(out) if out.dtype == torch.bool else float(out))
        if op in ("add", "sub") and lits[1] == 0.0 and not isinstance(lits[1], bool):
            return args[0]
        if op == "add" and lits[0] == 0.0 and not isinstance(lits[0], bool):
            return args[1]
        if op in ("mul", "div") and lits[1] == 1.0 and not isinstance(lits[1], bool):
            return args[0]
        if op == "mul" and lits[0] == 1.0 and not isinstance(lits[0], bool):
            return args[1]
        if op == "neg" and args[0].op == "neg":
            return args[0].args[0]
        return None

    def lit(self, c) -> Node:
        if isinstance(c, bool):
            return self.mk("lit", attr=c)
        return self.mk("lit", attr=float(c))

    def pow(self, a: Node, c: float) -> Node:
        """``a ** c`` for a number ``c``, as products where the exponent is a
        small integer or 0.5 (one rounding pattern for both emitters)."""
        c = float(c)
        if c == 0.0:
            return self.lit(1.0)
        if c == 1.0:
            return a
        if c == 2.0:
            return self.mk("mul", a, a)
        if c == 3.0:
            return self.mk("mul", self.mk("mul", a, a), a)
        if c == 0.5:
            return self.mk("sqrt", a)
        if c == -1.0:
            return self.mk("div", self.lit(1.0), a)
        if c == -2.0:
            return self.mk("div", self.lit(1.0), self.mk("mul", a, a))
        if c == -0.5:
            return self.mk("div", self.lit(1.0), self.mk("sqrt", a))
        return self.mk("pow", a, attr=c)

    # the tangent of a node along the flow: y -> w, a neighbour or a fixed
    # coordinate -> its velocity, a reduction -> the sum of its summands'
    # tangents
    def tangent(self, n: Node, memo: dict) -> Optional[Node]:
        if n.id in memo:
            return memo[n.id]
        memo[n.id] = t = self._tangent(n, memo)
        return t

    def _tangent(self, n, memo):
        op, a = n.op, n.args
        leaf = {"y": "w", "y0": "w0", "y1": "w1", "yo": "wo", "yk": "wk", "ya": "wa",
                "yg": "wg"}
        if op in leaf:
            return self.mk(leaf[op], attr=n.attr)
        if op in ("red", "mv", "mvx", "mvg"):  # a stage's tangent: its own stage's
            return self.mk("d" + op, attr=n.attr)
        if op == "seg":  # linear: the scatter-add of its rows' tangents
            ds = [self.tangent(x, memo) for x in a]
            if all(t is None for t in ds):
                return None
            return self.mk("seg", *(t if t is not None else self.lit(0.0) for t in ds),
                           attr=n.attr)
        if op == "sel":
            ds = [self.tangent(x, memo) for x in a]
            if all(t is None for t in ds):
                return None
            return self.mk("sel", *(t if t is not None else self.lit(0.0) for t in ds),
                           attr=n.attr)
        if not a or n.boolean or op in ("sign", "b2f"):
            return None
        da = [self.tangent(x, memo) for x in a]
        if all(t is None for t in da):
            return None
        mk, one = self.mk, self.lit(1.0)

        def z(t):
            return t if t is not None else self.lit(0.0)

        if op == "add":
            return da[0] if da[1] is None else da[1] if da[0] is None else mk("add", *da)
        if op == "sub":
            return (mk("neg", da[1]) if da[0] is None else da[0] if da[1] is None
                    else mk("sub", *da))
        if op == "neg":
            return mk("neg", da[0])
        if op == "mul":
            p = None if da[0] is None else mk("mul", da[0], a[1])
            q = None if da[1] is None else mk("mul", a[0], da[1])
            return p if q is None else q if p is None else mk("add", p, q)
        if op == "div":  # (da - (a / b) db) / b
            if da[1] is None:
                return mk("div", da[0], a[1])
            t = mk("mul", n, da[1])
            num = mk("neg", t) if da[0] is None else mk("sub", da[0], t)
            return mk("div", num, a[1])
        d0 = da[0]
        if op == "exp":
            return mk("mul", n, d0)
        if op == "expm1":
            return mk("mul", mk("exp", a[0]), d0)
        if op == "log":
            return mk("div", d0, a[0])
        if op == "log1p":
            return mk("div", d0, mk("add", one, a[0]))
        if op == "sqrt":
            return mk("div", d0, mk("mul", self.lit(2.0), n))
        if op == "sin":
            return mk("mul", mk("cos", a[0]), d0)
        if op == "cos":
            return mk("neg", mk("mul", mk("sin", a[0]), d0))
        if op == "tanh":
            return mk("mul", mk("sub", one, mk("mul", n, n)), d0)
        if op == "sinh":
            return mk("mul", mk("cosh", a[0]), d0)
        if op == "cosh":
            return mk("mul", mk("sinh", a[0]), d0)
        if op == "abs":
            return mk("mul", mk("sign", a[0]), d0)
        if op == "pow":
            return mk("mul", mk("mul", self.lit(n.attr), self.pow(a[0], n.attr - 1.0)), d0)
        if op in ("max", "min"):  # torch's rule: half of each at a tie
            pick = mk("gt" if op == "max" else "lt", a[0], a[1])
            wgt = mk("where", mk("eq", a[0], a[1]), self.lit(0.5),
                     mk("where", pick, one, self.lit(0.0)))
            return mk("add", z(da[1]), mk("mul", wgt, mk("sub", z(da[0]), z(da[1]))))
        if op == "where":
            return mk("where", a[0], z(da[1]), z(da[2]))
        raise AssertionError(f"no tangent rule for {op}")

    def relabel(self, n: Node, leaf, memo: dict) -> Node:
        """``n`` with each leaf ``x`` for which ``leaf(x)`` is not None
        replaced by it."""
        if n.id not in memo:
            new = leaf(n) if not n.args else None
            memo[n.id] = new if new is not None else n if not n.args else self.mk(
                n.op, *(self.relabel(a, leaf, memo) for a in n.args), attr=n.attr)
        return memo[n.id]

    def coord(self, kind: str, k: int) -> Node:
        """Coordinate ``k``'s position (``kind`` ``"y"``) or velocity
        (``"w"``), a chain value: ``y0``, ``y1``, else ``yk`` at ``k``."""
        return self.mk(f"{kind}{k}") if k in (0, 1) else self.mk(f"{kind}k", attr=k)

    def near(self, kind: str, delta: int) -> Node:
        """The position or velocity of coordinate ``i + delta``, a lane
        leaf (``y``/``w`` itself at 0)."""
        return self.mk(kind) if delta == 0 else self.mk(f"{kind}o", attr=delta)

    def affine(self, kind: str, s: int, c: int) -> Node:
        """The position or velocity of coordinate ``s i + c``: a neighbour
        where ``s`` is 1, else ``ya``/``wa`` (``s = -1``: a flip's read)."""
        return self.near(kind, c) if s == 1 else self.mk(f"{kind}a", attr=(s, c))

    def pin(self, n: Node, k: int, memo=None) -> Node:
        """A lane expression read at the fixed coordinate ``k``: a chain
        value."""
        if not n.lane:
            return n
        memo = {} if memo is None else memo
        if n.id in memo:
            return memo[n.id]
        if n.op in _PRODUCT_LEAVES or n.op == "seg":
            raise _FarRead()
        if n.op in ("y", "w", "yo", "wo"):
            out = self.coord(n.op[0], k + (n.attr or 0))
        elif n.op in ("yg", "wg"):
            out = self.coord(n.op[0], int(self.tables[n.attr[0]][k + n.attr[2]]))
        elif n.op in ("ya", "wa"):
            out = self.coord(n.op[0], n.attr[0] * k + n.attr[1])
        elif n.op == "prm":
            out = self.mk("prmk", attr=n.attr + k)
        elif n.op == "prmd":
            out = self.mk("prmk", attr=n.attr[0] + k // n.attr[1])
        elif n.op == "sel":
            out = self.pin(n.args[k % n.attr], k, memo)
        else:
            out = self.mk(n.op, *(self.pin(a, k, memo) for a in n.args), attr=n.attr)
        memo[n.id] = out
        return out

    def shift(self, n: Node, delta: int, memo=None) -> Node:
        """A lane expression moved from index ``i`` to ``i + delta``: its
        reads of coordinates, parameters and stages' rows keep their
        targets, so their offsets move the other way (``y`` becomes the
        neighbour at ``-delta``, a product's element at its own index ``mv``
        its row ``i - delta``, ``mvx``).  A parameter read at ``i / K``
        cannot move (callers never move a ``fixed`` expression)."""
        if not n.lane or delta == 0:
            return n
        assert not n.fixed, "a parameter at i / K moved to another index"
        memo = {} if memo is None else memo
        if n.id not in memo:
            if n.op == "prm":
                out = self.mk("prm", attr=n.attr - delta)
            elif n.op in ("mv", "dmv"):
                out = self.mk(n.op + "x", attr=(n.attr, 1, delta))
            elif n.op in ("mvx", "dmvx"):
                out = self.mk(n.op, attr=n.attr[:2] + (n.attr[2] + delta,))
            elif n.op in ("y", "w", "yo", "wo"):
                out = self.near(n.op[0], (n.attr or 0) - delta)
            elif n.op in ("ya", "wa"):
                out = self.mk(n.op, attr=(n.attr[0], n.attr[1] - n.attr[0] * delta))
            elif n.op in ("yg", "wg", "mvg", "dmvg", "seg"):  # table entry i + k - delta
                out = self.mk(n.op, *n.args, attr=n.attr[:-1] + (n.attr[-1] - delta,))
            elif n.op == "sel":  # argument k reads index k - delta's
                K = n.attr
                out = self.mk("sel", *(self.shift(n.args[(k - delta) % K], delta, memo)
                                       for k in range(K)), attr=K)
            else:
                out = self.mk(n.op, *(self.shift(a, delta, memo) for a in n.args), attr=n.attr)
            memo[n.id] = out
        return memo[n.id]


def taylor(b: Graph, n: Node, memo: dict):
    """``(c0, c1, c2)`` with ``n(x + v t) = c0 + c1 t + c2 t^2`` for a node of
    degree at most 2, in the leaves ``y`` = x, ``w`` = v (and ``y0``, ``w0``,
    ``y1``, ``w1``); None for a zero coefficient."""
    if n.id in memo:
        return memo[n.id]
    op, a = n.op, n.args
    if n.deg == 0:
        out = (n, None, None)
    elif op in ("y", "y0", "y1"):
        out = (n, b.mk({"y": "w", "y0": "w0", "y1": "w1"}[op]), None)
    else:
        ca = [taylor(b, x, memo) for x in a]

        def add(p, q):
            return p if q is None else q if p is None else b.mk("add", p, q)

        def mul(p, q):
            return None if p is None or q is None else b.mk("mul", p, q)

        if op == "add":
            out = tuple(add(p, q) for p, q in zip(*ca))
        elif op == "sub":
            out = tuple(p if q is None else (b.mk("neg", q) if p is None else b.mk("sub", p, q))
                        for p, q in zip(*ca))
        elif op == "neg":
            out = tuple(None if p is None else b.mk("neg", p) for p in ca[0])
        elif op == "mul":
            (p0, p1, p2), (q0, q1, q2) = ca
            out = (mul(p0, q0), add(mul(p0, q1), mul(p1, q0)),
                   add(add(mul(p0, q2), mul(p1, q1)), mul(p2, q0)))
        elif op == "div":  # by a constant in t
            out = tuple(None if p is None else b.mk("div", p, a[1]) for p in ca[0])
        else:
            raise AssertionError(f"{op} of degree {n.deg}")
    memo[n.id] = out
    return out


# ---------------------------------------------------------------------------
# abstract values of the trace
# ---------------------------------------------------------------------------

def _stage_of(op, attr) -> int:
    """The stage a product leaf reads."""
    return attr if op in ("mv", "dmv") else attr[0]


class Piece(NamedTuple):
    a: int           # positions [a, b)
    b: int
    off: Optional[int]  # coordinate i = p + off of a lane expression; None: a chain value
    e: Node


class Vec(NamedTuple):
    n: int
    pieces: Tuple[Piece, ...]


class Bad(NamedTuple):
    """A value the kernels cannot compute; raises once the gradient reads it."""
    err: LoweringError


class Mat(NamedTuple):
    """A value with two dimensions past 1 whose short axis, of ``K <=``
    :data:`KMAX`, is unrolled at lowering time: its ``K`` vectors along that
    axis (each a :class:`Vec` of one length ``n``), the axis first of the two
    (``kfirst``: shape ``(K, n)``) or second (``(n, K)``), dimensions of size
    1 aside."""
    vecs: Tuple[Vec, ...]
    kfirst: bool


class Rev(NamedTuple):
    """``flip(u)`` of a vector that reads a stage's output at its own index,
    pending: read by ``cumsum``, whose prefix scan of it is ``flip`` of the
    suffix scan of ``u`` (``Rev`` again), and by a second ``flip``, which
    gives ``u`` back, so that ``flip(cumsum(flip(u)))`` (the backward of
    ``cumsum``) is one suffix scan; read otherwise, it is the flipped vector,
    its stages read at the flipped rows (``_Interp._unrev``; ``node`` the
    flip's)."""
    vec: Vec
    node: object


class Lowered:
    """A lowered gradient at one (kernel, d, dtype): the output's pieces over
    the coordinates, its stages in trace order (``("red", r)``, a sum or a
    max; ``("mv", m)``, a product ``M u`` or a running sum), the sums' pieces (``reductions``) and
    index spaces, the products, the hoisted parameters (``params``, a float64
    vector, empty when there are none) and, from them, the torch pair and the
    header.  ``trans``: the products formed once per transition (stage
    order), their values at ``toff`` of the chain's ``n_trans`` per-transition
    values (``c0`` rows, then ``c1`` rows), and on the Boomerang their
    constant parts ``M u(0)`` at ``mc_off`` of the parameters.  ``point``:
    the kernel evaluates a stage at every point it evaluates (K3/K5, K4
    always; K1 and K6 unless every sum is one the chain moments extrapolate
    exactly and, on K1, every product is formed once per transition)."""

    def __init__(self, b: Graph, kernel: str, d: int, dtype, out: List[Piece],
                 stages: List[Tuple[str, int]], reductions: List[List[Piece]],
                 red_space: List[object], products: Dict[int, Product],
                 params: torch.Tensor, red_kind: Optional[List[str]] = None):
        self.b, self.kernel, self.d, self.dtype = b, kernel, d, dtype
        self.out, self.stages, self.params = out, stages, params
        self.reductions, self.red_space, self.products = reductions, red_space, products
        self.red_kind = red_kind or ["sum"] * len(reductions)
        memo: dict = {}
        self.d_out = [b.tangent(p.e, memo) for p in out]
        self.d_red = [[b.tangent(p.e, memo) for p in r] for r in reductions]
        self.d_mv = {m: [b.tangent(p.e, memo) for p in pr.vec.pieces]
                     for m, pr in products.items()}
        # each scatter-add's tangent, walked beside it (``_Emit.seg``)
        b.pairs = {x.id: memo[x.id] for e in self._values() for x in _nodes(e)
                   if x.op == "seg" and memo.get(x.id) is not None}
        self.trans = [m for kind, m in stages if kind == "mv" and kernel in TRANSITION_KERNELS
                      and all(p.e.deg <= 1 for p in products[m].vec.pieces)]
        self.toff, self.n_trans = {}, 0
        for m in self.trans:
            self.toff[m] = self.n_trans
            self.n_trans += 2 * products[m].rows
        self.point = kernel not in MOMENT_KERNELS or not self._moments_exact()
        block = kernel == "sticky" and self.point
        # the products formed at a point: on K6 every one in shared memory (a
        # Sums slot points there); on a lane's walk a product from the
        # coordinates to data rows is formed row by row where it is read
        # (inline: at a data loop's own row, or at any row from its input,
        # which the Sums keep where the gradient's coordinates read it, unless
        # it has more columns than rows); every other one fills a Sums slot of
        # slot_rows values, in stage order
        at_reads = {_stage_of(x.op, x.attr) for e in [p.e for p in out] + self.d_out
                    if e is not None for x in _nodes(e) if x.op in _PRODUCT_LEAVES}
        self.inline = set() if block else {
            m for m, pr in products.items() if m not in self.toff and pr.in_space == "c"
            and pr.space != "c" and not pr.scan and (m not in at_reads or pr.cols <= pr.rows)}
        self.kept = sorted(self.inline & at_reads)
        self.slot = {m: k for k, m in enumerate(
            m for kind, m in stages if kind == "mv" and m not in self.toff
            and m not in self.inline)}
        self.slot_rows = max((products[m].rows for m in self.slot), default=d)
        self._lits: dict = {}
        self._dev: dict = {}
        self._lib = None
        self.mc_off: Dict[int, int] = {}
        if kernel == "boomerang" and self.trans:
            self._hoist_constant_parts()

    def _moments_exact(self) -> bool:
        """Whether K1/K6's chain moments give every stage exactly: sums over
        the coordinates of summands of degree at most 2 in ``t`` that read
        their own coordinate and coordinates 0 and 1 alone (no sum read by
        another), and no product but those formed once per transition."""
        return all(m in self.toff for m in self.products) and all(
            k == "sum" for k in self.red_kind) and all(
            space == "c" and all(p.e.deg <= 2 and not _leaves(p.e) & _NOT_MOMENTS
                                 and 0 <= _coords(p)[0] and _coords(p)[1] <= self.d
                                 for p in pieces)
            for pieces, space in zip(self.reductions, self.red_space))

    def _hoist_constant_parts(self) -> None:
        """``mc = M u(0)`` of each per-transition product, in the run's dtype,
        appended to the parameters: the Boomerang reads a product along its
        elliptic flow from ``c0``, ``c1`` and ``mc``."""
        zero = torch.zeros((self.d, 1), dtype=self.dtype)
        prm = self.params.to(self.dtype)
        u0, _ = self._eval(zero, None, only=set(self.trans), prm=prm)
        parts = [self.params]
        off = self.params.numel()
        for m in self.trans:
            self.mc_off[m] = off
            parts.append(u0[m][:, 0].to(torch.float64))
            off += self.products[m].rows
        self.params = torch.cat(parts)

    def lane_bytes(self) -> int:
        """Bytes of one lane's context at a point (K1, K3/K5, K4): its
        ``Sums`` (the sums, the slots of products formed at the point and
        the inputs of the inline products the coordinates read, with their
        tangents; K1 keeps two alive, a segment's two grid points), the
        other products' materialized inputs with their
        tangents, and the walk of the data rows' products into the
        coordinates (a row's input and tangent each, and the accumulators
        that an unrolled walk keeps beside the ``Sums``).  Products formed
        once per transition are not counted."""
        kept = sum(2 * self.products[m].cols for m in self.kept)
        sums = 2 * len(self.reductions) + 2 * len(self.slot) * self.slot_rows + kept
        inputs = sum(2 * pr.cols for m, pr in self.products.items()
                     if pr.in_space == "c" and m not in self.toff and not pr.scan) - kept
        rows = [self.products[m] for m in self.slot if self.products[m].in_space != "c"]
        walk = sum(2 + (2 * pr.rows if _unroll(pr.rows) else 0) for pr in rows)
        return (((2 if self.kernel == "zigzag" else 1) * sums + inputs + walk)
                * self.dtype.itemsize)

    def shared_values(self) -> int:
        """Values of K6's context in shared memory: each product's input and
        output with their tangents."""
        return sum(2 * (pr.cols + pr.rows) for pr in self.products.values())

    # -- the torch pair (the plain version) ---------------------------------
    def grad(self, y: torch.Tensor) -> torch.Tensor:
        """The gradient of ``(d, B)`` chains, chain-minor."""
        return self._eval(y, None)[0]

    def grad_jvp(self, y: torch.Tensor, w: torch.Tensor):
        """The gradient and its derivative along ``w``, ``H(y) w``."""
        return self._eval(y, w)

    def params_on(self, device, dtype) -> torch.Tensor:
        """The parameters on ``device`` in ``dtype`` (copied once)."""
        key = (torch.device(device), dtype)
        if key not in self._dev:
            self._dev[key] = self.params.to(device=key[0], dtype=dtype)
        return self._dev[key]

    def matrix(self, m: int, prm: torch.Tensor) -> torch.Tensor:
        """Product ``m``'s ``(rows, cols)`` matrix, a view of ``prm``."""
        pr = self.products[m]
        block = prm[pr.moff:pr.moff + pr.rows * pr.cols]
        return (block.view(pr.cols, pr.rows).t() if pr.colmajor
                else block.view(pr.rows, pr.cols))

    def _read(self, c0s: dict, c1s: dict, tau: torch.Tensor, elliptic: bool) -> dict:
        """``{m: (value, tangent)}``: the per-transition products (``c0s``,
        ``c1s``) read at the times ``tau`` ``(N,)`` of their transition as
        the kernels read them (``Transition::prod`` in
        ``csrc/pdmp_common.cuh``), ``c0 + tau c1`` and ``c1`` along the
        linear flow, ``a cos tau + c1 sin tau + mc`` and ``c1 cos tau - a sin
        tau`` (``a = c0 - mc``) along the elliptic one; ``N`` a multiple of
        the transition's columns, which repeat."""
        out = {}
        prm = self.params_on(tau.device, tau.dtype) if elliptic else None
        for m in self.trans:
            c0, c1 = c0s[m], c1s[m]
            reps = tau.shape[0] // c0.shape[1]
            if reps > 1:
                c0, c1 = c0.repeat(1, reps), c1.repeat(1, reps)
            if elliptic:
                mc = prm[self.mc_off[m]:self.mc_off[m] + self.products[m].rows, None]
                a = c0 - mc
                c, s = torch.cos(tau), torch.sin(tau)
                out[m] = (a * c + c1 * s + mc, c1 * c - a * s)
            else:
                out[m] = (c0 + tau * c1, c1)
        return out

    def along(self, x: torch.Tensor, v: torch.Tensor, elliptic: bool = False,
              parts: Optional[int] = None):
        """``pair(y, w, tau) -> (g, H(y) w)``: the pair at the point ``(y,
        w)`` the flow reaches at times ``tau`` from the transition's start
        ``(x, v)`` (``(d, N)`` chains), its per-transition products formed
        once from ``(x, v)``, ``c0 = M u(x)`` and ``c1 = M du(x; v)``, every
        element added in column order as the kernels' ``form`` adds it (a
        running sum in ``parts`` runs, :data:`FORM_PARTS` by default: the
        caller's lanes), and read at ``tau`` (:meth:`_read`), every other
        stage formed at the point (``w`` None: the gradient alone): the
        plain version of the kernels' pair."""
        c0s, c1s = self._eval(x, v, only=set(self.trans), parts=parts or FORM_PARTS)

        def pair(y, w, tau):
            return self._eval(y, w, fixed=self._read(c0s, c1s, tau, elliptic))

        return pair

    def _eval(self, y, w, fixed=None, only=None, prm=None, parts=None):
        """The pair at ``(y, w)`` (``w`` None: the gradient alone); ``fixed``
        the per-transition products' values and tangents there, their stages
        skipped; ``only`` a set of products, formed alone (a running sum in
        ``parts`` runs, :data:`FORM_PARTS` by default) and returned as
        ``(values, tangents)`` dicts."""
        prm = self.params_on(y.device, y.dtype) if prm is None else prm
        key = (y.device, y.dtype)
        if key not in self._lits:
            self._lits[key] = {}
        lits = self._lits[key]
        chain: dict = {}
        red, dred, prod, dprod = {}, {}, {}, {}
        segs: dict = {}
        ones = (1, y.shape[1])

        def table(off, lo, hi):  # an index table's entries [lo, hi), exact
            return prm[off + lo:off + hi].long()

        def ev(n: Node, lo: int, hi: int, lane: dict):
            memo = lane if n.lane else chain
            if n.id in memo:
                return memo[n.id]
            op, a = n.op, n.args
            if op == "lit":
                if n.attr not in lits:
                    lits[n.attr] = torch.tensor(n.attr, dtype=torch.bool if n.boolean
                                                else y.dtype, device=y.device)
                out = lits[n.attr]
            elif op == "y":
                out = y[lo:hi]
            elif op == "w":
                out = w[lo:hi]
            elif op in ("y0", "y1", "w0", "w1"):
                k = int(op[1]) if y.shape[0] > 1 else 0
                out = (y if op[0] == "y" else w)[k]
            elif op in ("yo", "wo"):
                out = (y if op == "yo" else w)[lo + n.attr:hi + n.attr]
            elif op in ("yk", "wk"):
                out = (y if op == "yk" else w)[n.attr]
            elif op in ("ya", "wa"):
                st, c = n.attr
                src = y if op == "ya" else w
                out = (src[st * lo + c:st * (hi - 1) + c + 1:st] if st > 0 else
                       src[torch.arange(lo, hi, device=y.device) * st + c])
            elif op in ("yg", "wg"):
                t, _, k = n.attr
                out = (y if op == "yg" else w).index_select(0, table(t, lo + k, hi + k))
            elif op == "seg":  # the segments' sums over their rows, formed once
                ptr, rows, m, n_rows, spans, k = n.attr
                key = (ptr, rows, spans, tuple(x.id for x in a))
                if key not in segs:
                    vals = [torch.broadcast_to(ev(x, ra if off is None else ra + off,
                                                  rb if off is None else rb + off, {}),
                                               (rb - ra, y.shape[1]))
                            for (ra, rb, off), x in zip(spans, a)]
                    segs[key] = ordered_segment_sum(torch.cat(vals, 0), table(ptr, 0, m + 1),
                                                    table(rows, 0, n_rows))
                out = segs[key][lo + k:hi + k]
            elif op == "prm":
                out = prm[n.attr + lo:n.attr + hi, None]
            elif op == "prmd":
                out = prm[n.attr[0] + torch.arange(lo, hi, device=y.device) // n.attr[1], None]
            elif op in ("mvx", "dmvx"):
                m, st, c = n.attr
                rows = (torch.arange(lo, hi, device=y.device) - c) // st
                out = (prod if op == "mvx" else dprod)[m][rows]
            elif op in ("mvg", "dmvg"):
                m, t, _, k = n.attr
                out = (prod if op == "mvg" else dprod)[m].index_select(0, table(t, lo + k, hi + k))
            elif op == "sel":  # argument i % K at index i
                vals = torch.stack([torch.broadcast_to(ev(x, lo, hi, lane), (hi - lo, y.shape[1]))
                                    for x in a])
                pick = (torch.arange(lo, hi, device=y.device) % n.attr)[None, :, None]
                out = vals.gather(0, pick.expand(1, hi - lo, y.shape[1]))[0]
            elif op == "prmk":
                out = prm[n.attr]
            elif op in ("red", "dred", "mv", "dmv"):
                out = {"red": red, "dred": dred, "mv": prod, "dmv": dprod}[op][n.attr]
                if op in ("mv", "dmv"):
                    out = out[lo:hi]
            elif op == "b2f":
                out = ev(a[0], lo, hi, lane).to(y.dtype)
            else:
                out = _TORCH[op](*(ev(x, lo, hi, lane) for x in a), n.attr)
            memo[n.id] = out
            return out

        def assemble(pieces, nodes):
            parts = []
            for p, e in zip(pieces, nodes):
                lo, hi = (p.a, p.b) if p.off is None else (p.a + p.off, p.b + p.off)
                if e is None:
                    parts.append(torch.zeros((hi - lo,) + ones[1:], dtype=y.dtype,
                                             device=y.device))
                    continue
                v = ev(e, lo, hi, {})
                parts.append(torch.broadcast_to(v, (hi - lo, y.shape[1])))
            return torch.cat(parts, 0)

        n = y.shape[1]
        for m, (val, dval) in (fixed or {}).items():
            prod[m], dprod[m] = val, dval
        todo = [(kind, s) for kind, s in self.stages
                if not ((kind == "mv" and s in prod) or (only is not None and not (
                    kind == "mv" and s in only)))]
        for group in self._batches(todo):
            kind, s = group[0]
            # a stage's value and tangent side by side, added in one pass; a
            # batch of products with one matrix side by side too
            us = []
            for _, m in group:
                pieces, tangents = ((self.reductions[m], self.d_red[m]) if kind == "red" else
                                    (self.products[m].vec.pieces, self.d_mv[m]))
                u = assemble(pieces, [p.e for p in pieces])
                if kind == "red" and self.red_kind[m] == "max":
                    red[m], dred[m] = ordered_max(
                        u, None if w is None else assemble(pieces, tangents))
                    break
                us.append(u if w is None else torch.cat([u, assemble(pieces, tangents)], 1))
            if not us:
                continue
            if kind == "red":
                out = ordered_sum(us[0], 0)[0]
            elif self.products[s].scan:  # the kernels' runs where formed per transition
                out = ordered_scan(torch.cat(us, 1), self.products[s].scan,
                                   (parts or FORM_PARTS) if only is not None else 1)
            else:
                out = ordered_matvec(self.matrix(s, prm), torch.cat(us, 1))
            for q, (_, m) in enumerate(group):
                part = out[..., q * us[0].shape[1]:(q + 1) * us[0].shape[1]]
                (red, prod)[kind != "red"][m] = part[..., :n]
                if w is not None:
                    (dred, dprod)[kind != "red"][m] = part[..., n:]
        if only is not None:
            return prod, dprod
        g = assemble(self.out, [p.e for p in self.out])
        return g, (None if w is None else assemble(self.out, self.d_out))

    def _batches(self, stages):
        """Stages in order, products of one matrix that follow one another
        and read none of each other batched (the plain version adds their
        elements side by side, each in its own column order)."""
        out: list = []
        for kind, s in stages:
            last = out[-1] if out else None
            if (kind == "mv" and last and last[0][0] == "mv"
                    and self._key(last[0][1]) == self._key(s)
                    and not self._reads_products(s) & {m for _, m in last}):
                last.append((kind, s))
            else:
                out.append([(kind, s)])
        return out

    def _key(self, m):
        pr = self.products[m]
        return pr.scan, pr.moff, pr.colmajor, pr.rows, pr.cols, pr.in_space == "c"

    def _reads_products(self, m) -> set:
        """The products product ``m``'s input reads."""
        return {x.attr if x.op in ("mv", "dmv") else x.attr[0]
                for p in self.products[m].vec.pieces for x in _nodes(p.e)
                if x.op in _PRODUCT_LEAVES}

    # -- the CUDA header ----------------------------------------------------
    def header(self) -> str:
        """``UserPotential<T>`` for this kernel (``csrc/pdmp_common.cuh``)."""
        nr = max(len(self.reductions), 1)
        npc = max(len(self.slot), 1)
        block = self.kernel == "sticky" and self.point
        lines = [
            "// Generated by pdmpflux_tpu_torch/ops/cuda/lower.py: a lowered gradient",
            f"// for kernel {self.kernel}, d = {self.d}, {str(self.dtype).split('.')[-1]}.",
            "// Included by csrc/pdmp_common.cuh inside namespace pdmp.",
            "#pragma once",
            f"using UserScalar = {'double' if self.dtype == torch.float64 else 'float'};",
            "template <typename T>",
            "struct UserPotential {",
            f"  static constexpr bool chain = {'true' if self.reductions else 'false'};",
            f"  static constexpr bool point = {'true' if self.point else 'false'};",
            f"  static constexpr bool reads_others = "
            f"{'true' if self._reads(_OTHERS) else 'false'};",
            f"  static constexpr int NR = {nr};",
            f"  static constexpr long shared_bytes = "
            f"{self.shared_values() if block else 0}L * (long)sizeof(T);",
            f"  static constexpr int NP = {self.n_trans};  // values formed once per transition",
            "  struct Sums {",
            "    T s[NR], ds[NR];",
        ]
        if self.slot and block:
            lines += [f"    const T* c[{npc}];", f"    const T* dc[{npc}];"]
        elif self.slot:
            lines += [f"    T c[{npc}][{self.slot_rows}], dc[{npc}][{self.slot_rows}];"]
        lines += [f"    T u{m}[{self.products[m].cols}], du{m}[{self.products[m].cols}];"
                  for m in self.kept]
        lines.append("  };")
        if self.trans:
            lines += self._form_cpp()
        if not self.point:
            lines += self._moments_cpp()
        else:
            if self.kernel in MOMENT_KERNELS:
                lines += _MOMENTS_STUB
            lines += self._fill_cpp() if block else self._sums_cpp()
        lines += self._at_cpp()
        lines += ["};", ""]
        return "\n".join(lines)

    def _values(self):
        """Every node of the output and the stages (not their tangents)."""
        return [p.e for p in self.out] + [p.e for pieces, _ in self._stage_pieces()
                                          for p in pieces]

    def _nodes_read(self):
        """Every node of the output, the stages and their tangents."""
        nodes = [p.e for p in self.out] + self.d_out
        for pieces, tangents in self._stage_pieces():
            nodes += [p.e for p in pieces] + list(tangents)
        return [e for e in nodes if e is not None]

    def _stage_pieces(self):
        """Every stage's (pieces, tangents)."""
        for kind, s in self.stages:
            if kind == "red":
                yield self.reductions[s], self.d_red[s]
            else:
                yield self.products[s].vec.pieces, self.d_mv[s]

    def _reads(self, leaves, stages_only=False) -> bool:
        """Whether any stage, or (unless ``stages_only``) any coordinate's
        gradient, reads one of ``leaves``: with :data:`_OTHERS`, a coordinate
        other than the evaluated one (K6 then makes the chain's values
        visible to every thread before it reads them); with coordinates 0
        and 1, a point context reads them first through ``yw``."""
        nodes = [] if stages_only else [p.e for p in self.out] + self.d_out
        for pieces, tangents in self._stage_pieces():
            nodes += [p.e for p in pieces] + list(tangents)
        return any(e is not None and _leaves(e) & leaves for e in nodes)

    def _acc(self, r: int, v: str, dv: str, first: str) -> List[str]:
        """Stage ``r``'s accumulation of one term: a sum adds it, a max takes
        it where it is larger (or a NaN over a number), so the first index
        that attains the max gives the value and the tangent."""
        if self.red_kind[r] == "max":
            return [f"if ({first} || {v} > cs.s[{r}] || "
                    f"({v} != {v} && cs.s[{r}] == cs.s[{r}])) {{",
                    f"  cs.s[{r}] = {v};", f"  cs.ds[{r}] = {dv};", "}"]
        return [f"cs.s[{r}] = {first} ? {v} : cs.s[{r}] + {v};",
                f"cs.ds[{r}] = {first} ? {dv} : cs.ds[{r}] + {dv};"]

    def _moments_cpp(self):
        out = [
            "  // the chain moments of K1/K6: sum r at time t along the linear flow",
            "  // is m[3r] + t (m[3r + 1] + t m[3r + 2])",
            "  struct Moments {",
            "    static constexpr int N = 3 * NR;",
            "    T m[N];",
            "    __device__ __forceinline__ Sums at(T t) const {",
            "      Sums c;",
            "#pragma unroll",
            "      for (int r = 0; r < NR; ++r) {",
            "        c.s[r] = m[3 * r] + t * (m[3 * r + 1] + t * m[3 * r + 2]);",
            "        c.ds[r] = m[3 * r + 1] + (T)2 * t * m[3 * r + 2];",
            "      }",
            "      return c;",
            "    }",
            "  };",
            "  __device__ __forceinline__ static Moments moments_zero(int) {",
            "    Moments m;",
            "#pragma unroll",
            "    for (int q = 0; q < Moments::N; ++q) m.m[q] = (T)0;",
            "    return m;",
            "  }",
            "  // coordinate i's Taylor terms of every summand, at the transition's start",
            "  __device__ __forceinline__ static void moment_add(Moments& m, int i, T y, T w,",
            "                                                   T y0, T w0, T y1, T w1,",
            "                                                   const T* prm) {",
        ]
        used = False
        for r, pieces in enumerate(self.reductions):
            for p in pieces:
                lo, hi = _coords(p)
                tmemo: dict = {}
                cs = taylor(self.b, p.e, tmemo)
                em = _Emit(self.b)
                names = [None if c is None else em.name(c) for c in cs]
                out.append(f"    if (i >= {lo} && i < {hi}) {{  // sum {r}: {p.e.text()}")
                out += ["      " + s for s in em.lines]
                for q, nm in enumerate(names):
                    if nm is not None:
                        out.append(f"      m.m[{3 * r + q}] += {nm};")
                        used = True
                out.append("    }")
        if not used:
            out.append("    (void)m; (void)i; (void)y; (void)w; (void)y0; (void)w0; "
                       "(void)y1; (void)w1; (void)prm;")
        out.append("  }")
        return out

    def _m(self, m: int, r: str, c: str) -> str:
        """Product ``m``'s matrix element ``(r, c)`` read from the parameters."""
        pr = self.products[m]
        return (f"prm[{pr.moff} + ({c}) * {pr.rows} + ({r})]" if pr.colmajor
                else f"prm[{pr.moff} + ({r}) * {pr.cols} + ({c})]")

    def _coord_leaf(self, op, m, at):
        return f"cs.{'d' if op == 'dmv' else ''}c[{self.slot[m]}][{at}]"

    def _emit(self, kept=False, **kw) -> "_Emit":
        """An emitter that reads the per-transition products through the
        point's accessor (``yw.prod``), a slot's rows from the Sums, and an
        inline product's row at any index from its input (``sums``' own
        ``u<m>``, or with ``kept`` the Sums' copies ``cs.u<m>``)."""
        mc = {m: f"prm + {o}" for m, o in self.mc_off.items()}
        rows = {m: "cs." for m in self.kept} if kept else {m: "" for m in self.inline}
        return _Emit(self.b, trans={m: (self.toff[m], self.products[m].rows,
                                        mc.get(m, "nullptr")) for m in self.trans},
                     leaf=self._coord_leaf, rows=rows, rowfn=self._row_lines, **kw)

    def _row_lines(self, m, at, z, src):
        """Row ``at`` of product ``m`` and its tangent (``z``, ``d<z>``) from
        its input ``<src>u<m>``, added in column order as
        :func:`ordered_matvec` adds."""
        pr = self.products[m]
        a0 = self._m(m, at, "0")
        return [f"T {z} = {a0} * {src}u{m}[0], d{z} = {a0} * {src}du{m}[0];",
                *_unroll(pr.cols),
                f"for (int c = 1; c < {pr.cols}; ++c) {{",
                f"  const T a = {self._m(m, at, 'c')};",
                f"  {z} = {z} + a * {src}u{m}[c];",
                f"  d{z} = d{z} + a * {src}du{m}[c];",
                "}"]

    def _read_barrier(self, m) -> bool:
        """Whether product ``m``'s rows are read at an index other than
        their own (a gather, a shift, a flip, a placement, a scatter-add's
        rows): on K6 another thread wrote them."""
        for e in self._nodes_read():
            for x in _nodes(e):
                if x.op in ("mvx", "dmvx", "mvg", "dmvg") and x.attr[0] == m:
                    return True
                if x.op == "seg" and any(y.op in ("mv", "dmv") and y.attr == m
                                         for a in x.args for y in _nodes(a)):
                    return True
        return False

    def _reads_point(self, *nodes) -> bool:
        return any(n is not None and _leaves(n) & {"y", "w"} for n in nodes)

    def _form_cpp(self):
        """``form``: the per-transition products at the transition's start,
        in stage order.  A matrix's rows: the caller takes rows ``part``,
        ``part + parts``, ... of it (the lanes of a chain read adjacent rows,
        so a column-major matrix is read in whole sectors), :data:`FORM_ROWS`
        at a time, each added in column order: their accumulators are
        independent chains of adds, and the input's pieces are evaluated
        once for them, where their columns are read.  A running sum: the
        caller takes a run of coordinates (mirrored for a suffix) and adds
        it in order, then the totals of the runs before it, by shuffle in
        run order (:func:`ordered_scan`).  A stage that reads an earlier one
        (``y - s cumsum(z)``) reads its ``c0`` and ``c1`` after a
        ``__syncwarp`` of the caller's lanes."""
        out = [
            "  // the products formed once per transition: c0 = M u(x) and c1 = M du(x; v)",
            "  // at the transition's start (yw(j, y, w) gives coordinate j's x and v),",
            "  // value q of the chain at pv[q * ps], c0's rows then c1's; the caller is",
            "  // lane `part` of the chain's `parts` lanes, which call it together",
            "  template <class F>",
            "  __device__ __forceinline__ static void form(int d, int part, int parts,",
            "                                              const T* prm, F yw, T* pv, long ps) {",
            "    (void)d; (void)prm; (void)yw;",
            "    // the chain's lanes: the caller's aligned group of `parts` in its warp",
            "    const unsigned mask = parts >= 32 ? 0xffffffffu",
            "        : ((1u << parts) - 1u) << ((threadIdx.x & 31) & ~(parts - 1));",
            "    (void)mask;",
        ]
        if any(_leaves(p.e) & _FIRST for m in self.trans for p in self.products[m].vec.pieces):
            out += _READ01
        done: set = set()
        for m in self.trans:
            if self._reads_products(m) & done:
                out.append("    __syncwarp(mask);  // the earlier products' rows, every lane's")
            out += self._form_scan(m) if self.products[m].scan else self._form_rows(m)
            done.add(m)
        out.append("  }")
        return out

    def _form_emit(self) -> "_Emit":
        """An emitter for ``form``: an earlier per-transition product's
        element is its ``c0`` (tangent ``c1``) as it lies in ``pv``."""
        def leaf(op, m, at):
            o = self.toff[m] + (self.products[m].rows if op == "dmv" else 0)
            return f"pv[({o} + ({at})) * ps]"
        return _Emit(self.b, leaf=leaf)

    def _form_input(self, p, dp, q):
        """A piece of a per-transition product's input at position ``q``:
        its statements and the value and tangent's names."""
        em = self._form_emit()
        v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
        lines = [f"const int i = {q} + {p.off or 0};", "(void)i;"]
        if self._reads_point(p.e, dp):
            lines += ["T y, w;", "yw(i, y, w);", "(void)y; (void)w;"]
        return lines + em.lines, v, dv

    def _form_rows(self, m):
        nb = FORM_ROWS
        pr, o = self.products[m], self.toff[m]
        R = pr.rows
        out = [f"    // product {m}: ({R} x {pr.cols}) u, rows part, part + parts, ...",
               f"    for (int j = part; j < {R}; j += {nb} * parts) {{",
               f"      T acc[{nb}], dacc[{nb}];",
               f"      int rs[{nb}];",
               "#pragma unroll",
               f"      for (int k = 0; k < {nb}; ++k) {{",
               f"        rs[k] = min(j + k * parts, {R - 1});  // a row past the last repeats it",
               "        acc[k] = dacc[k] = (T)0;",
               "      }"]
        for p, dp in zip(pr.vec.pieces, self.d_mv[m]):
            lines, v, dv = self._form_input(p, dp, "q")
            out += [f"      for (int q = {p.a}; q < {p.b}; ++q) {{  // {p.e.text()}"]
            out += ["        " + s for s in lines]
            out += ["#pragma unroll",
                    f"        for (int k = 0; k < {nb}; ++k) {{",
                    f"          const T a = {self._m(m, 'rs[k]', 'q')};",
                    f"          acc[k] = q == 0 ? a * {v} : acc[k] + a * {v};",
                    f"          dacc[k] = q == 0 ? a * {dv} : dacc[k] + a * {dv};",
                    "        }", "      }"]
        return out + ["#pragma unroll",
                      f"      for (int k = 0; k < {nb}; ++k) {{",
                      f"        if (j + k * parts < {R}) {{",
                      f"          pv[({o} + rs[k]) * ps] = acc[k];",
                      f"          pv[({o + R} + rs[k]) * ps] = dacc[k];",
                      "        }", "      }", "    }"]

    def _form_scan(self, m):
        pr, o = self.products[m], self.toff[m]
        R, suffix = pr.rows, pr.scan == "suffix"
        at = f"{R - 1} - r" if suffix else "r"  # run position r's coordinate
        out = [f"    {{  // running sum {m} ({pr.scan}) over {R} coordinates: this lane's run",
               f"      const int per = ({R} + parts - 1) / parts;",
               f"      const int r0 = min({R}, part * per), r1 = min({R}, r0 + per);",
               "      T s = (T)0, ds = (T)0;",
               "      bool first = true;"]
        pieces = list(zip(pr.vec.pieces, self.d_mv[m]))
        for p, dp in (pieces[::-1] if suffix else pieces):
            # positions [a, b) are run positions [R - b, R - a) of a suffix
            lo, hi = (R - p.b, R - p.a) if suffix else (p.a, p.b)
            lines, v, dv = self._form_input(p, dp, "c")
            out += [f"      for (int r = max(r0, {lo}); r < min(r1, {hi}); ++r) {{  "
                    f"// {p.e.text()}",
                    f"        const int c = {at};"]
            out += ["        " + s for s in lines]
            out += [f"        s = first ? {v} : s + {v};",
                    f"        ds = first ? {dv} : ds + {dv};",
                    "        first = false;",
                    f"        pv[({o} + c) * ps] = s;",
                    f"        pv[({o + R} + c) * ps] = ds;",
                    "      }"]
        return out + [
            "      // the totals of the runs before this one, added in run order",
            "      T off = (T)0, doff = (T)0;",
            "      for (int k = 0; k < parts; ++k) {",
            "        const T tk = __shfl_sync(mask, s, k, parts);",
            "        const T dtk = __shfl_sync(mask, ds, k, parts);",
            "        if (k < part) {",
            "          off = off + tk;",
            "          doff = doff + dtk;",
            "        }",
            "      }",
            "      for (int r = r0; r < r1; ++r) {",
            f"        const int c = {at};",
            f"        pv[({o} + c) * ps] = off + pv[({o} + c) * ps];",
            f"        pv[({o + R} + c) * ps] = doff + pv[({o + R} + c) * ps];",
            "      }",
            "    }"]

    def _sums_cpp(self):
        """``sums``: every stage formed at the point, one lane walking the
        chain (K1 in point mode, K3/K5, K4), each sum and each product element
        added in index order as the plain version adds it."""
        out = [
            "  // every sum and product formed at one point, one lane walking the chain,",
            "  // in the plain version's order: yw(j, y, w) gives coordinate j's point and",
            "  // velocity, yw.prod a per-transition product's element there",
            "  template <class F>",
            "  __device__ __forceinline__ static Sums sums(int d, const T* prm, F yw) {",
            "    Sums cs;",
            "    (void)d; (void)prm; (void)yw;",
        ]
        if self._reads(_FIRST, stages_only=True):
            out += _READ01
        for batch in self._batches([(kind, s) for kind, s in self.stages
                                    if not (kind == "mv" and s in self.toff)]):
            kind, s = batch[0]
            if kind == "red":
                out += self._lane_red(s)
            elif self.products[s].in_space != "c":
                out += self._lane_rows([m for _, m in batch])
            else:
                for _, m in batch:
                    out += self._lane_product(m)
        out += ["    return cs;", "  }"]
        return out

    def _inline_products(self, nodes, indent):
        """A data loop's inline products at its own row ``k`` (``z<m>``,
        ``dz<m>``), each element added in column order: the lines and the
        products."""
        ms = sorted({x.attr for n in nodes if n is not None for x in _nodes(n, rows=False)
                     if x.op in ("mv", "dmv") and x.attr in self.inline})
        out = [s for m in ms for s in self._row_lines(m, "k", f"z{m}", "")]
        return [indent + s for s in out], set(ms)

    def _lane_red(self, r):
        pieces, tangents = self.reductions[r], self.d_red[r]
        out = [f"    bool first{r} = true;"]
        if self.red_space[r] == "c":
            for p, dp in zip(pieces, tangents):
                lo, hi = _coords(p)
                em = self._emit()
                v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
                out += ["    " + u for u in _unroll(hi - lo)]
                out += [f"    for (int i = {lo}; i < {hi}; ++i) {{  // sum {r}: {p.e.text()}",
                        "      T y, w;", "      yw(i, y, w);", "      (void)y; (void)w;"]
                out += ["      " + s for s in em.lines]
                out += ["      " + s for s in self._acc(r, v, dv, f"first{r}")]
                out += [f"      first{r} = false;", "    }"]
            return out
        n = max(p.b for p in pieces)
        out.append(f"    for (int k = 0; k < {n}; ++k) {{  // sum {r} over data rows")
        lines, zk = self._inline_products([p.e for p in pieces] + list(tangents), "      ")
        out += lines
        for p, dp in zip(pieces, tangents):
            em = self._emit(idx="k", own=False, zk=zk)
            v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
            out.append(f"      if (k >= {p.a} && k < {p.b}) {{  // {p.e.text()}")
            out += ["        " + s for s in em.lines]
            out += ["        " + s for s in self._acc(r, v, dv, f"first{r}")]
            out += [f"        first{r} = false;", "      }"]
        out.append("    }")
        return out

    def _lane_product(self, m):
        """A product of the coordinates: its input in the lane's registers,
        then ``M u`` into the coordinates' slot, or nothing more where its
        rows are data rows (formed row by row where read)."""
        pr, tangents = self.products[m], self.d_mv[m]
        R, C = pr.rows, pr.cols
        if pr.scan:
            return self._lane_scan(m)
        out = [f"    T u{m}[{C}], du{m}[{C}];  // product {m}: ({R} x {C}) u"]
        for p, dp in zip(pr.vec.pieces, tangents):
            em = self._emit()
            v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
            out += ["    " + u for u in _unroll(p.b - p.a)]
            out += [f"    for (int p = {p.a}; p < {p.b}; ++p) {{  // {p.e.text()}",
                    f"      const int i = p + {p.off or 0};", "      (void)i;"]
            if self._reads_point(p.e, dp):
                out += ["      T y, w;", "      yw(i, y, w);", "      (void)y; (void)w;"]
            out += ["      " + s for s in em.lines]
            out += [f"      u{m}[p] = {v};", f"      du{m}[p] = {dv};", "    }"]
        if m in self.kept:  # the coordinates read its rows: the Sums keep its input
            out += ["    " + u for u in _unroll(C)]
            out += [f"    for (int c = 0; c < {C}; ++c) {{",
                    f"      cs.u{m}[c] = u{m}[c];", f"      cs.du{m}[c] = du{m}[c];", "    }"]
        if m not in self.slot:
            return out
        k = self.slot[m]
        a0 = self._m(m, "r", "0")
        return out + [
            *["    " + u for u in _unroll(R)],
            f"    for (int r = 0; r < {R}; ++r) {{",
            f"      T acc = {a0} * u{m}[0], dacc = {a0} * du{m}[0];",
            *["      " + u for u in _unroll(C)],
            f"      for (int c = 1; c < {C}; ++c) {{",
            f"        const T a = {self._m(m, 'r', 'c')};",
            f"        acc = acc + a * u{m}[c];",
            f"        dacc = dacc + a * du{m}[c];",
            "      }",
            f"      cs.c[{k}][r] = acc;",
            f"      cs.dc[{k}][r] = dacc;",
            "    }"]

    def _lane_scan(self, m):
        """A running sum at the point: the lane adds its input into the
        coordinates' slot in index order (from the last coordinate for a
        suffix), as :func:`ordered_scan` adds with one part."""
        pr, k = self.products[m], self.slot[m]
        suffix = pr.scan == "suffix"
        out = [f"    bool first{m} = true;  // running sum {m} ({pr.scan})"]
        pieces = list(zip(pr.vec.pieces, self.d_mv[m]))
        for p, dp in (pieces[::-1] if suffix else pieces):
            em = self._emit()
            v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
            prev = "p + 1" if suffix else "p - 1"
            loop = (f"for (int p = {p.b - 1}; p >= {p.a}; --p)" if suffix
                    else f"for (int p = {p.a}; p < {p.b}; ++p)")
            out += ["    " + u for u in _unroll(p.b - p.a)]
            out += [f"    {loop} {{  // {p.e.text()}",
                    f"      const int i = p + {p.off or 0};", "      (void)i;"]
            if self._reads_point(p.e, dp):
                out += ["      T y, w;", "      yw(i, y, w);", "      (void)y; (void)w;"]
            out += ["      " + s for s in em.lines]
            out += [f"      cs.c[{k}][p] = first{m} ? {v} : cs.c[{k}][{prev}] + {v};",
                    f"      cs.dc[{k}][p] = first{m} ? {dv} : cs.dc[{k}][{prev}] + {dv};",
                    f"      first{m} = false;", "    }"]
        return out

    def _lane_rows(self, ms):
        """Products of one matrix from data rows into the coordinates (one, or
        a matrix product's backward ``X.T @ G``, one per column of ``G``) in
        one walk of the rows: each row's inputs formed once, a piece over
        every row beside the others' (the subexpressions they share, a row's
        softmax, formed once), a piece over some rows under its guard; every
        output element takes row k's term in turn, in registers where the
        loop unrolls, as the plain version adds it."""
        pr = self.products[ms[0]]
        R, C = pr.rows, pr.cols
        unroll = bool(_unroll(R))
        accs = {m: ((f"a{m}", f"da{m}") if unroll else
                    (f"cs.c[{self.slot[m]}]", f"cs.dc[{self.slot[m]}]")) for m in ms}
        out = [f"    T a{m}[{R}], da{m}[{R}];" for m in ms] if unroll else []
        out.append(f"    for (int k = 0; k < {C}; ++k) {{  // products {ms}: ({R} x {C}) u, "
                   "u over data rows")
        lines, zk = self._inline_products([n for m in ms for p, dp in zip(
            self.products[m].vec.pieces, self.d_mv[m]) for n in (p.e, dp)], "      ")
        out += lines
        em = self._emit(idx="k", own=False, zk=zk)
        us, guarded = [], []
        for m in ms:
            pieces, tangents = self.products[m].vec.pieces, self.d_mv[m]
            if len(pieces) == 1 and (pieces[0].a, pieces[0].b) == (0, C):
                dp = tangents[0]
                us.append((em.name(pieces[0].e), em.name(dp) if dp is not None else "(T)0"))
                continue
            guarded.append(f"      T u{m} = (T)0, du{m} = (T)0;")
            for p, dp in zip(pieces, tangents):
                pe = self._emit(idx="k", own=False, zk=zk)
                v, dv = pe.name(p.e), pe.name(dp) if dp is not None else "(T)0"
                guarded.append(f"      if (k >= {p.a} && k < {p.b}) {{  // {p.e.text()}")
                guarded += ["        " + s for s in pe.lines]
                guarded += [f"        u{m} = {v};", f"        du{m} = {dv};", "      }"]
            us.append((f"u{m}", f"du{m}"))
        out += ["      " + s for s in em.lines] + guarded
        out += ["      " + u for u in _unroll(R)]
        out += [f"      for (int r = 0; r < {R}; ++r) {{",
                f"        const T a = {self._m(ms[0], 'r', 'k')};"]
        for m, (v, dv) in zip(ms, us):
            acc, dacc = accs[m]
            out += [f"        {acc}[r] = k == 0 ? a * {v} : {acc}[r] + a * {v};",
                    f"        {dacc}[r] = k == 0 ? a * {dv} : {dacc}[r] + a * {dv};"]
        out += ["      }", "    }"]
        if unroll:
            for m in ms:
                out += ["    #pragma unroll", f"    for (int r = 0; r < {R}; ++r) {{",
                        f"      cs.c[{self.slot[m]}][r] = a{m}[r];",
                        f"      cs.dc[{self.slot[m]}][r] = da{m}[r];", "    }"]
        return out

    def _fill_cpp(self):
        """``fill``: every stage at one point by K6's block (one CTA per
        chain): a stage's positions across the threads; a product's input,
        then its output, in shared memory, a barrier after each; a sum by a
        two-level reduction whose total every thread holds in the same
        bits.  Every thread of the block calls it."""
        out = [
            "  // a block sum: every thread returns the same bits (a warp's xor",
            "  // butterfly, one partial per warp, the partials added alike in every warp)",
            "  __device__ __forceinline__ static T block_sum(T v, T* row) {",
            "#pragma unroll",
            "    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);",
            "    if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;",
            "    __syncthreads();",
            "    const int l = threadIdx.x & 31;",
            "    T a = l < (int)(blockDim.x >> 5) ? row[l] : (T)0;",
            "#pragma unroll",
            "    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);",
            "    return a;",
            "  }",
        ]
        if "max" in self.red_kind:
            out += _BLOCK_MAX
        scans = any(pr.scan for pr in self.products.values())
        if scans:
            out += _BLOCK_SCAN
        out += [
            "  // every sum and product at one point, by the block: shm holds each",
            "  // product's input and output (shared_bytes); yw(j, y, w) gives",
            "  // coordinate j's point and velocity",
            "  template <class F>",
            "  __device__ static Sums fill(int d, const T* prm, T* shm, F yw) {",
            "    const int tid = threadIdx.x, nt = blockDim.x;",
            "    Sums cs;",
            "    (void)d; (void)prm; (void)shm; (void)yw; (void)tid; (void)nt;",
        ]
        if self.reductions:
            out.append(f"    __shared__ T rows[{2 * len(self.reductions)}][32];")
        if "max" in self.red_kind:
            out.append(f"    __shared__ int irows[{len(self.reductions)}][32];")
        if scans:
            out.append("    __shared__ T srows[2][32];  // the running sums' warp totals")
        off = 0
        for kind, m in self.stages:
            if kind != "mv":
                continue
            pr = self.products[m]
            out += [f"    T* u{m} = shm + {off};", f"    T* du{m} = shm + {off + pr.cols};",
                    f"    T* o{m} = shm + {off + 2 * pr.cols};",
                    f"    T* do{m} = shm + {off + 2 * pr.cols + pr.rows};"]
            off += 2 * (pr.cols + pr.rows)
            if m in self.slot:
                out += [f"    cs.c[{self.slot[m]}] = o{m};", f"    cs.dc[{self.slot[m]}] = do{m};"]
        out.append("    __syncthreads();  // every thread has read the last point's context")
        if self._reads(_FIRST, stages_only=True):
            out += _READ01

        def leaf(op, m, at):
            return f"{'d' if op == 'dmv' else ''}o{m}[{at}]"

        def loop(pieces, tangents, body):
            lines = []
            for p, dp in zip(pieces, tangents):
                em = _Emit(self.b, leaf=leaf)
                v, dv = em.name(p.e), em.name(dp) if dp is not None else "(T)0"
                lines += [f"    for (int p = {p.a} + tid; p < {p.b}; p += nt) {{  // {p.e.text()}",
                          f"      const int i = p + {p.off or 0};", "      (void)i;"]
                if self._reads_point(p.e, dp):
                    lines += ["      T y, w;", "      yw(i, y, w);", "      (void)y; (void)w;"]
                lines += ["      " + s for s in em.lines] + [
                    "      " + s for s in body(v, dv)] + ["    }"]
            return lines

        for kind, s in self.stages:
            if kind == "red" and self.red_kind[s] == "max":
                out.append(f"    T part{s} = (T)(-INFINITY), dpart{s} = (T)0;  // max {s}")
                out.append(f"    int ipart{s} = 0x7fffffff;")
                out += loop(self.reductions[s], self.d_red[s], lambda v, dv, s=s: [
                    f"if (max_wins({v}, p, part{s}, ipart{s})) {{",
                    f"  part{s} = {v};", f"  dpart{s} = {dv};", f"  ipart{s} = p;", "}"])
                out += [f"    block_max(part{s}, dpart{s}, ipart{s}, rows[{2 * s}], "
                        f"rows[{2 * s + 1}], irows[{s}]);",
                        f"    cs.s[{s}] = part{s};", f"    cs.ds[{s}] = dpart{s};"]
                continue
            if kind == "red":
                out.append(f"    T part{s} = (T)0, dpart{s} = (T)0;  // sum {s}")
                out += loop(self.reductions[s], self.d_red[s],
                            lambda v, dv, s=s: [f"part{s} += {v};", f"dpart{s} += {dv};"])
                out += [f"    cs.s[{s}] = block_sum(part{s}, rows[{2 * s}]);",
                        f"    cs.ds[{s}] = block_sum(dpart{s}, rows[{2 * s + 1}]);"]
                continue
            pr = self.products[s]
            out.append(f"    // {'running sum' if pr.scan else 'product'} {s}: "
                       f"({pr.rows} x {pr.cols}) u")
            out += loop(pr.vec.pieces, self.d_mv[s],
                        lambda v, dv, s=s: [f"u{s}[p] = {v};", f"du{s}[p] = {dv};"])
            if pr.scan:
                out += ["    __syncthreads();",
                        f"    block_scan(u{s}, du{s}, o{s}, do{s}, {pr.rows}, "
                        f"{'true' if pr.scan == 'suffix' else 'false'}, srows[0], srows[1]);"]
                continue
            a0 = self._m(s, "r", "0")
            out += ["    __syncthreads();",
                    f"    for (int r = tid; r < {pr.rows}; r += nt) {{",
                    f"      T acc = {a0} * u{s}[0], dacc = {a0} * du{s}[0];",
                    f"      for (int c = 1; c < {pr.cols}; ++c) {{",
                    f"        const T a = {self._m(s, 'r', 'c')};",
                    f"        acc = acc + a * u{s}[c];",
                    f"        dacc = dacc + a * du{s}[c];",
                    "      }",
                    f"      o{s}[r] = acc;",
                    f"      do{s}[r] = dacc;",
                    "    }",
                    "    __syncthreads();" + ("  // its rows are read at other indices"
                                           if self._read_barrier(s) else "")]
        out += ["    return cs;", "  }"]
        return out

    def _at_cpp(self):
        out = [
            "  // gradient component i at x + v t and its derivative along v; yw(j, y, w)",
            "  // gives coordinate j's point and velocity",
            "  template <class F>",
            "  __device__ __forceinline__ static void at(int i, T xi, T vi, T x0, T v0, T x1,",
            "                                            T v1, T t, const T* prm,",
            "                                            const Sums& cs, F yw, T& g, T& dg) {",
        ]
        reads = set()
        for p, dp in zip(self.out, self.d_out):
            reads |= _leaves(p.e) | (_leaves(dp) if dp is not None else set())
        point = {"y": "const T y = xi + vi * t;", "w": "const T w = vi;",
                 "y0": "const T y0 = x0 + v0 * t;", "w0": "const T w0 = v0;",
                 "y1": "const T y1 = x1 + v1 * t;", "w1": "const T w1 = v1;"}
        out += ["    " + point[k] for k in ("y", "w", "y0", "w0", "y1", "w1") if k in reads]
        out.append("    (void)i; (void)xi; (void)vi; (void)x0; (void)v0; (void)x1; (void)v1; "
                   "(void)t; (void)prm; (void)cs; (void)yw;")
        for n, (p, dp) in enumerate(zip(self.out, self.d_out)):
            lo, hi = _coords(p)
            last = n == len(self.out) - 1
            cond = "" if last and n == 0 else (f"if (i < {hi}) " if n == 0 else
                                               "else " if last else f"else if (i < {hi}) ")
            em = self._emit(kept=True)
            g = em.name(p.e)
            dg = em.name(dp) if dp is not None else "(T)0"
            out.append(f"    {cond}{{  // coordinates [{lo}, {hi}): {p.e.text()}")
            out += ["      " + s for s in em.lines]
            out += [f"      g = {g};", f"      dg = {dg};", "    }"]
        out.append("  }")
        return out

    def library(self):
        """The chunk library of this kernel built with this potential
        (``build.user_library``; built at first use, then loaded)."""
        if self._lib is None:
            from . import build
            self._lib = build.user_library(SOURCES[self.kernel], self.header())
        return self._lib


UNROLL = 32
"""Loops of a lane's context up to this many steps are unrolled, so that its
small arrays (a product's input, the accumulators) live in registers."""
FORM_ROWS = 4
"""Rows of a per-transition product one lane forms at once (``form``)."""
FORM_PARTS = 32
"""Runs of a per-transition running sum: K3/K5's warp forms it in 32, K1's
group in its L lanes (``driver`` hands the plain version K1's L)."""


def ordered_scan(u: torch.Tensor, kind: str, parts: int = 1) -> torch.Tensor:
    """The running sum over axis 0 of ``(n, B)`` values, ``kind``
    ``"prefix"`` (``cumsum``) or ``"suffix"`` (from the last position), in
    the kernels' order: ``parts`` runs of ``ceil(n / parts)`` positions
    (mirrored for a suffix), each added in order, then each run's values
    after the totals of the runs before it, added in run order as ``form``'s
    shuffles add them; ``parts`` 1: one lane walking the chain
    (``UserPotential::sums``), as :func:`ordered_sum` adds."""
    n = u.shape[0]
    a = u.flip(0) if kind == "suffix" else u
    per = -(-n // parts)
    if parts * per > n:  # empty runs past the last position
        a = torch.cat([a, a.new_zeros((parts * per - n,) + a.shape[1:])])
    a = a.reshape((parts, per) + a.shape[1:])
    runs = [a[:, 0]]
    for j in range(1, per):
        runs.append(runs[-1] + a[:, j])
    out = torch.stack(runs, 1)
    if parts > 1:
        off, offs = torch.zeros_like(out[0, -1]), []
        for k in range(parts):
            offs.append(off)
            off = off + out[k, -1]
        out = torch.stack(offs)[:, None] + out
    out = out.reshape((parts * per,) + out.shape[2:])[:n]
    return out.flip(0) if kind == "suffix" else out


def ordered_segment_sum(vals: torch.Tensor, ptr: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """Segment ``i`` of ``(n, B)`` values: the sum of ``vals[rows[q]]`` for
    ``q`` in ``[ptr[i], ptr[i + 1])`` (the rows sorted stably by their
    target, so each segment's in increasing order), added in ``q`` order from
    its first term, an empty segment 0: as the kernels' segment walk adds
    (never ``index_put``'s accumulation, whose order is no contract)."""
    start, lens = ptr[:-1], ptr[1:] - ptr[:-1]
    out = vals.new_zeros((start.shape[0],) + vals.shape[1:])
    if rows.numel() == 0:
        return out
    terms = vals.index_select(0, rows)
    shape = (-1,) + (1,) * (vals.dim() - 1)
    for j in range(int(lens.max())):
        term = terms.index_select(0, torch.clamp(start + j, max=rows.numel() - 1))
        out = torch.where((lens > j).view(shape), term if j == 0 else out + term, out)
    return out


def _unroll(n: int) -> List[str]:
    return ["#pragma unroll"] if n <= UNROLL else []


_BLOCK_MAX = [
    "  // a max's order: a larger value, a NaN over a number, the lower index at a",
    "  // tie (a total order, so that every thread of a reduction takes one winner)",
    "  __device__ __forceinline__ static bool max_wins(T a, int ia, T b, int ib) {",
    "    if (a != a) return b == b || ia < ib;",
    "    if (b != b) return false;",
    "    return a > b || (a == b && ia < ib);",
    "  }",
    "  __device__ __forceinline__ static void max_step(T& v, T& dv, int& ix, int o) {",
    "    const T ov = __shfl_xor_sync(0xffffffffu, v, o);",
    "    const T odv = __shfl_xor_sync(0xffffffffu, dv, o);",
    "    const int oi = __shfl_xor_sync(0xffffffffu, ix, o);",
    "    if (max_wins(ov, oi, v, ix)) { v = ov; dv = odv; ix = oi; }",
    "  }",
    "  // a block max of (value, tangent, index): every thread returns the winner's",
    "  // bits (a warp's xor butterfly, one partial per warp, the partials taken",
    "  // alike in every warp)",
    "  __device__ __forceinline__ static void block_max(T& v, T& dv, int& ix, T* row,",
    "                                                  T* drow, int* irow) {",
    "#pragma unroll",
    "    for (int o = 16; o > 0; o >>= 1) max_step(v, dv, ix, o);",
    "    if ((threadIdx.x & 31) == 0) {",
    "      row[threadIdx.x >> 5] = v;",
    "      drow[threadIdx.x >> 5] = dv;",
    "      irow[threadIdx.x >> 5] = ix;",
    "    }",
    "    __syncthreads();",
    "    const int l = threadIdx.x & 31;",
    "    const bool has = l < (int)(blockDim.x >> 5);",
    "    v = has ? row[l] : (T)(-INFINITY);",
    "    dv = has ? drow[l] : (T)0;",
    "    ix = has ? irow[l] : 0x7fffffff;",
    "#pragma unroll",
    "    for (int o = 16; o > 0; o >>= 1) max_step(v, dv, ix, o);",
    "  }",
]
"""K6's block max (``UserPotential::fill``), beside its ``block_sum``."""

_BLOCK_SCAN = [
    "  // a block's running sum of n values and their tangents, u into o (from the",
    "  // last position where rev): thread tid adds its run of ceil(n / nt) positions",
    "  // (mirrored where rev) in order, the runs' totals are scanned by a warp's",
    "  // shuffles and the warp totals (row, drow) by every warp, and each run adds",
    "  // the totals before it; every thread calls it, and o is read after it",
    "  __device__ static void block_scan(const T* u, const T* du, T* o, T* dout, int n,",
    "                                    bool rev, T* row, T* drow) {",
    "    const int tid = threadIdx.x, nt = blockDim.x, l = tid & 31, wp = tid >> 5;",
    "    const int per = (n + nt - 1) / nt;",
    "    const int r0 = min(n, tid * per), r1 = min(n, r0 + per);",
    "    T s = (T)0, ds = (T)0;",
    "    for (int r = r0; r < r1; ++r) {",
    "      const int c = rev ? n - 1 - r : r;",
    "      s = r == r0 ? u[c] : s + u[c];",
    "      ds = r == r0 ? du[c] : ds + du[c];",
    "      o[c] = s;",
    "      dout[c] = ds;",
    "    }",
    "    T a = s, da = ds;  // the warp's inclusive scan of the runs' totals",
    "#pragma unroll",
    "    for (int k = 1; k < 32; k <<= 1) {",
    "      const T b = __shfl_up_sync(0xffffffffu, a, k);",
    "      const T db = __shfl_up_sync(0xffffffffu, da, k);",
    "      if (l >= k) {",
    "        a = a + b;",
    "        da = da + db;",
    "      }",
    "    }",
    "    if (l == 31) {",
    "      row[wp] = a;",
    "      drow[wp] = da;",
    "    }",
    "    __syncthreads();",
    "    T off = __shfl_up_sync(0xffffffffu, a, 1), doff = __shfl_up_sync(0xffffffffu, da, 1);",
    "    if (l == 0) off = doff = (T)0;",
    "    T wo = (T)0, dwo = (T)0;",
    "    for (int k = 0; k < wp; ++k) {",
    "      wo = wo + row[k];",
    "      dwo = dwo + drow[k];",
    "    }",
    "    off = wo + off;",
    "    doff = dwo + doff;",
    "    for (int r = r0; r < r1; ++r) {",
    "      const int c = rev ? n - 1 - r : r;",
    "      o[c] = off + o[c];",
    "      dout[c] = doff + dout[c];",
    "    }",
    "    __syncthreads();",
    "  }",
]
"""K6's block scan of a running sum formed at the point (``UserPotential::fill``)."""


_READ01 = ["    T y0, w0, y1, w1;", "    yw(0, y0, w0);",
           "    if (d > 1) yw(1, y1, w1); else { y1 = y0; w1 = w0; }"]
"""A point context's reads of coordinates 0 and 1."""

_MOMENTS_STUB = [
    "  // no chain moments: the kernel forms every stage at each point",
    "  struct Moments {",
    "    static constexpr int N = 1;",
    "    T m[N];",
    "  };",
    "  __device__ __forceinline__ static Moments moments_zero(int) { return Moments{}; }",
    "  __device__ __forceinline__ static void moment_add(Moments&, int, T, T, T, T, T, T,",
    "                                                   const T*) {}",
]


def _coords(p: Piece):
    """The coordinates ``[lo, hi)`` a piece covers (a chain piece: its
    positions)."""
    off = 0 if p.off is None else p.off
    return p.a + off, p.b + off


def _nodes(n: Node, rows: bool = True):
    """Every node ``n`` reads, itself included, once each; ``rows`` False:
    not the rows of a scatter-add (evaluated at other indices)."""
    seen, stack = set(), [n]
    while stack:
        x = stack.pop()
        if x.id not in seen:
            seen.add(x.id)
            yield x
            if rows or x.op != "seg":
                stack.extend(x.args)


def _leaves(n: Node) -> set:
    """The ops of ``n``'s leaves, and ``"seg"`` where it reads a scatter-add."""
    return {x.op for x in _nodes(n) if not x.args or x.op == "seg"}


def _hexlit(c) -> str:
    if isinstance(c, bool):
        return "true" if c else "false"
    if math.isnan(c):
        return "(T)NAN"
    if math.isinf(c):
        return "(T)INFINITY" if c > 0 else "(T)(-INFINITY)"
    return f"(T){float(c).hex()}"


_CPP_BIN = {"add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">", "ge": ">=",
            "lt": "<", "le": "<=", "eq": "==", "ne": "!=", "and": "&&", "or": "||"}
_CPP_FN = {"exp": "exp", "expm1": "expm1", "log": "log", "log1p": "log1p", "sqrt": "sqrt",
           "sin": "sin", "cos": "cos", "tanh": "tanh", "sinh": "sinh", "cosh": "cosh",
           "abs": "fabs"}


class _Emit:
    """SSA statements of a DAG, one ``const`` per node, in dependency order;
    a parameter reads ``prm[off + idx]``, a stage's element at row ``at``
    (its own index, ``(i - c) / s`` or a table's entry) ``leaf(op, m,
    at)`` (a per-transition product's, ``trans[m] = (offset, rows, mc)``,
    the accessor's ``yw.prod``; a product in ``zk`` at the index,
    ``z<m>``, formed before; one in ``rows`` formed at that row from its
    input, :meth:`row`), a neighbour, a fixed coordinate or a gathered one
    the accessor ``yw`` (once each), a scatter-add its segment walk
    (:meth:`seg`).  ``own`` False: the index is not the point's own
    coordinate, whose ``y``/``w`` are read through ``yw`` too; ``parent``:
    the emitter of the enclosing scope, which names every chain value."""

    def __init__(self, b: Graph, idx: str = "i", leaf=None, trans=None, own=True,
                 parent=None, rows=None, rowfn=None, zk=()):
        self.b, self.lines, self.names, self.read = b, [], {}, set()
        self.idx, self.leaf, self.trans = idx, leaf, trans or {}
        self.own, self.parent = own, parent
        self.rows, self.rowfn, self.zk = rows or {}, rowfn, set(zk)
        self.pv: Dict[tuple, str] = {}
        self.zr: Dict[tuple, str] = {}

    def row(self, m: int, at: str, tangent: bool) -> str:
        """Product ``m``'s row ``at`` and its tangent, formed once here from
        its input (``rows[m]`` says where that lies)."""
        if (m, at) not in self.zr:
            name = self.zr[m, at] = f"zr{m}_{len(self.zr)}"
            self.lines += [f"const int {name}_at = {at};",
                           *self.rowfn(m, f"{name}_at", name, self.rows[m])]
        return f"{'d' if tangent else ''}{self.zr[m, at]}"

    def at_row(self, n: Node) -> Tuple[int, str]:
        """The stage a product leaf reads and the row it reads, as C."""
        if n.op in ("mv", "dmv"):
            return n.attr, self.idx
        if n.op in ("mvg", "dmvg"):
            m, t, _, k = n.attr
            return m, f"(int)prm[{t + k} + {self.idx}]"
        m, st, c = n.attr  # (i - c) / s: exact for s = +-1, a placement's row for s = K
        return m, f"({self.idx} - ({c})) / {st}" if c else f"{self.idx} / {st}"

    def prod(self, m: int, at: str, tangent: bool) -> str:
        """A per-transition product's element at row ``at`` and its tangent,
        read with one call of ``yw.prod``."""
        if (m, at) not in self.pv:
            name = self.pv[m, at] = f"pv{m}" if at == self.idx else f"pv{m}_{len(self.pv)}"
            o, rows, mc = self.trans[m]
            self.lines += [f"T {name}, d{name};",
                           f"yw.prod({o}, {rows}, {at}, {mc}, {name}, d{name});"]
        return f"{'d' if tangent else ''}{self.pv[m, at]}"

    def far(self, n: Node) -> str:
        """A neighbour's or a fixed coordinate's position or velocity, read
        with its partner by one call of ``yw``."""
        if n.op in ("yo", "wo"):
            tag = f"{'p' if n.attr > 0 else 'm'}{abs(n.attr)}"
            j = f"{self.idx} {'+' if n.attr > 0 else '-'} {abs(n.attr)}"
        elif n.op in ("ya", "wa"):
            st, c = n.attr
            tag = f"s{'m' if st < 0 else ''}{abs(st)}{'p' if c >= 0 else 'm'}{abs(c)}"
            j = (f"{c} - {self.idx}" if st == -1 else
                 f"{st} * {self.idx} {'+' if c >= 0 else '-'} {abs(c)}")
        elif n.op in ("yg", "wg"):  # an index table's entry: exact in the parameters
            t, _, k = n.attr
            tag = f"g{t}{'p' if k >= 0 else 'm'}{abs(k)}"
            j = f"(int)prm[{t + k} + {self.idx}]"
        elif n.op in ("y", "w"):  # the index's own coordinate, not the point's
            tag, j = "at", self.idx
        else:
            tag, j = f"k{n.attr}", str(n.attr)
        if tag not in self.read:
            self.read.add(tag)
            self.lines += [f"T y{tag}, w{tag};", f"yw({j}, y{tag}, w{tag});",
                           f"(void)y{tag}; (void)w{tag};"]
        return f"{n.op[0]}{tag}"

    def seg(self, n: Node) -> str:
        """A scatter-add's value at the index, and its tangent's where
        :attr:`Graph.pairs` has it, in one walk of the index's segment: each
        row ``r`` of it in increasing order (``ptr[i + k]`` to ``ptr[i + k +
        1]`` of the rows sorted by target), its term evaluated at ``r`` (its
        piece's index ``r + off``) and added as :func:`ordered_segment_sum`
        adds."""
        ptr, rows, _, n_rows, spans, k = n.attr
        nodes = [n]
        pair = self.b.pairs.get(n.id)
        if pair is not None and pair.id not in self.names:
            nodes.append(pair)
        names = [f"sg{x.id}" for x in nodes]
        body = []
        for j, (a, b_, off) in enumerate(spans):
            inner = _Emit(self.b, idx="sr", own=False, parent=self, leaf=self.leaf,
                          trans=self.trans, rows=self.rows, rowfn=self.rowfn)
            vals = [inner.name(x.args[j]) for x in nodes]
            block = [f"const int sr = sr0 + {off or 0};", "(void)sr;", *inner.lines]
            block += [f"{nm} = sq == sq0 ? {v} : {nm} + {v};" for nm, v in zip(names, vals)]
            if len(spans) == 1:
                body += block
            else:
                body += [f"if (sr0 >= {a} && sr0 < {b_}) {{", *["  " + x for x in block], "}"]
        self.lines += [f"T {', '.join(nm + ' = (T)0' for nm in names)};  // scatter-add rows",
                       "{",
                       f"  const int sq0 = (int)prm[{ptr + k} + {self.idx}], "
                       f"sq1 = (int)prm[{ptr + k + 1} + {self.idx}];",
                       "  for (int sq = sq0; sq < sq1; ++sq) {",
                       f"    const int sr0 = (int)prm[{rows} + sq];  // of {n_rows} rows",
                       *["    " + x for x in body], "  }", "}"]
        for x, nm in zip(nodes, names):
            self.names[x.id] = nm
        return names[0]

    def name(self, n: Node) -> str:
        if n.id in self.names:
            return self.names[n.id]
        op, a = n.op, n.args
        if op == "lit":
            return _hexlit(n.attr)
        if self.parent is not None and not n.lane:
            return self.parent.name(n)
        if op == "seg":
            return self.seg(n)
        if op in _FAR or (op in ("y", "w") and not self.own):
            return self.far(n)
        leaf = {"y": "y", "w": "w", "y0": "y0", "w0": "w0", "y1": "y1", "w1": "w1"}
        if op in leaf:
            return leaf[op]
        if op == "prm":
            return f"prm[{n.attr} + {self.idx}]"
        if op == "prmd":
            return f"prm[{n.attr[0]} + {self.idx} / {n.attr[1]}]"
        if op in _PRODUCT_LEAVES:
            tangent = op[0] == "d"
            m, at = self.at_row(n)
            if m in self.trans:
                return self.prod(m, at, tangent)
            if at == self.idx and m in self.zk:
                return f"{'d' if tangent else ''}z{m}"
            if m in self.rows:
                return self.row(m, at, tangent)
            return self.leaf("dmv" if tangent else "mv", m, at)
        if op == "prmk":
            return f"prm[{n.attr}]"
        if op == "red":
            return f"cs.s[{n.attr}]"
        if op == "dred":
            return f"cs.ds[{n.attr}]"
        args = [self.name(x) for x in a]
        if op in _CPP_BIN:
            expr = f"{args[0]} {_CPP_BIN[op]} {args[1]}"
        elif op in _CPP_FN:
            expr = f"{_CPP_FN[op]}({args[0]})"
        elif op == "neg":
            expr = f"-{args[0]}"
        elif op == "not":
            expr = f"!{args[0]}"
        elif op == "pow":
            expr = f"pow({args[0]}, {_hexlit(n.attr)})"
        elif op == "sign":
            expr = (f"{args[0]} > (T)0 ? (T)1 : ({args[0]} < (T)0 ? (T)-1 : {args[0]})")
        elif op == "max":  # NaN-propagating, as torch.maximum
            expr = f"({args[0]} != {args[0]} || {args[0]} > {args[1]}) ? {args[0]} : {args[1]}"
        elif op == "min":
            expr = f"({args[0]} != {args[0]} || {args[0]} < {args[1]}) ? {args[0]} : {args[1]}"
        elif op == "where":
            expr = f"{args[0]} ? {args[1]} : {args[2]}"
        elif op == "sel":
            expr = args[-1]
            for k in range(n.attr - 2, -1, -1):
                expr = f"{self.idx} % {n.attr} == {k} ? {args[k]} : ({expr})"
        elif op == "b2f":
            expr = f"{args[0]} ? (T)1 : (T)0"
        else:
            raise AssertionError(op)
        name = f"n{n.id}"
        self.lines.append(f"const {'bool' if n.boolean else 'T'} {name} = {expr};")
        self.names[n.id] = name
        return name


def _sign(a):
    return torch.where(torch.isnan(a), a, torch.sign(a))


def ordered_max(u: torch.Tensor, du: Optional[torch.Tensor]):
    """The max over axis 0 of ``(n, B)`` values and the tangent ``du`` there,
    both taken at the first index that attains it (the first NaN where there
    is one), as the kernels' running max takes them in index order."""
    top = torch.amax(u, 0, keepdim=True)
    hit = (u == top) | (torch.isnan(u) & torch.isnan(top))
    at = torch.argmax(hit.to(u.dtype), 0, keepdim=True)  # the first index hit
    return (torch.gather(u, 0, at)[0],
            None if du is None else torch.gather(du.expand_as(u), 0, at)[0])


_TORCH = {
    "add": lambda a, b, _: a + b, "sub": lambda a, b, _: a - b,
    "mul": lambda a, b, _: a * b, "div": lambda a, b, _: a / b,
    "neg": lambda a, _: -a, "exp": lambda a, _: torch.exp(a),
    "expm1": lambda a, _: torch.expm1(a), "log": lambda a, _: torch.log(a),
    "log1p": lambda a, _: torch.log1p(a), "sqrt": lambda a, _: torch.sqrt(a),
    "sin": lambda a, _: torch.sin(a), "cos": lambda a, _: torch.cos(a),
    "tanh": lambda a, _: torch.tanh(a), "sinh": lambda a, _: torch.sinh(a),
    "cosh": lambda a, _: torch.cosh(a), "abs": lambda a, _: torch.abs(a),
    "sign": lambda a, _: _sign(a),
    "pow": lambda a, c: torch.pow(a, torch.tensor(c, dtype=a.dtype, device=a.device)),
    "max": lambda a, b, _: torch.maximum(a, b), "min": lambda a, b, _: torch.minimum(a, b),
    "where": lambda c, a, b, _: torch.where(c, a, b),
    "gt": lambda a, b, _: a > b, "ge": lambda a, b, _: a >= b,
    "lt": lambda a, b, _: a < b, "le": lambda a, b, _: a <= b,
    "eq": lambda a, b, _: a == b, "ne": lambda a, b, _: a != b,
    "not": lambda a, _: ~a, "and": lambda a, b, _: a & b, "or": lambda a, b, _: a | b,
}


# ---------------------------------------------------------------------------
# the interpreter of the aten graph
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "neg": "neg", "exp": "exp",
    "expm1": "expm1", "log": "log", "log1p": "log1p", "sqrt": "sqrt", "sin": "sin",
    "cos": "cos", "tanh": "tanh", "sinh": "sinh", "cosh": "cosh", "abs": "abs",
    "sign": "sign", "sgn": "sign", "maximum": "max", "minimum": "min", "gt": "gt",
    "ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne", "logical_not": "not",
    "logical_and": "and", "logical_or": "or", "where": "where",
}
_COMPOUND = {"rsqrt", "reciprocal", "sigmoid", "pow", "rsub", "clamp", "clamp_min",
             "clamp_max", "square"}
_LIKE = {"full_like", "ones_like", "zeros_like", "empty_like", "new_zeros", "new_ones",
         "new_full", "new_empty", "scalar_tensor", "full", "zeros", "ones", "empty",
         "arange"}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous", "_to_copy"}
_RESHAPE = {"view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "expand",
            "flatten", "permute", "t"}
_PRODUCTS = {"mm", "mv", "dot", "vdot", "addmm", "addmv", "bmm"}
"""Products the kernels evaluate where one operand is a constant matrix
(``matmul``, ``linear`` and ``einsum`` reach the trace as these)."""
_SCANS = {"cumsum", "flip", "roll"}
"""Running sums (a stage), flips and periodic shifts along the coordinates
(reads at ``d - 1 - i`` and pieces moved), kept undecomposed."""
_GATHERS = {"index", "index_select", "gather", "take"}
"""Reads at a constant 1-D index array (``x[idx]``), kept undecomposed."""
_SCATTERS = {"index_put", "put", "scatter_add", "index_add", "scatter"}
"""Writes at a constant index array: the adding ones (a gather's backward)
are scatter-adds into the coordinates, ``scatter`` refused by name."""
_COUPLING = {"outer", "cumprod", "sort", "conv1d", "convolution"}
"""Ops that couple coordinates otherwise (kept undecomposed, so that a refusal
names them)."""


_SOFTMAX = ("_log_softmax", "_softmax", "_log_softmax_backward_data",
            "_softmax_backward_data")
"""Split into ``amax``, ``sub``, ``exp``, ``sum`` and ``log`` beside the core
decompositions, which keep them whole."""


def _decompositions():
    from torch._decomp import core_aten_decompositions, decomposition_table

    whole = _PRODUCTS | _COUPLING | _SCANS | _GATHERS | _SCATTERS | {"matmul", "einsum",
                                                                     "linear"}
    table = dict(core_aten_decompositions())
    for op in list(table):
        name = getattr(op, "name", lambda: str(op))()
        if name.split("::")[-1].split(".")[0] in whole:
            del table[op]
    for name in _SOFTMAX:
        op = getattr(torch.ops.aten, name).default
        if op in decomposition_table:
            table[op] = decomposition_table[op]
    return table


class Product(NamedTuple):
    """``M u`` for a constant ``(rows, cols)`` matrix hoisted at ``moff``
    (``M[r, c]`` at ``moff + c * rows + r`` where ``colmajor``, else at
    ``moff + r * cols + c``) and a vector ``vec`` of ``cols`` positions;
    ``space`` is its output's index space (``"c"`` where ``rows == d``, else
    the data length ``rows``), ``in_space`` its input's.  ``scan``: a
    running sum over the coordinates, ``"prefix"`` (``cumsum``) or
    ``"suffix"`` (``flip(cumsum(flip(u)))``), the product with a triangular
    matrix of ones, which is never hoisted (``moff`` -1)."""
    rows: int
    cols: int
    moff: int
    colmajor: bool
    vec: "Vec"
    space: object
    in_space: object
    scan: Optional[str] = None


def _nonunit(shape) -> int:
    return sum(1 for s in shape if s != 1)


def _shape(a):
    """The shape of an argument of an aten node (a graph node's traced value,
    or a tensor), or None."""
    val = a.meta.get("val") if hasattr(a, "meta") else a
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


class _Interp:
    def __init__(self, gm, d: int, dtype, device):
        self.gm, self.d, self.dtype, self.device = gm, d, dtype, device
        self.b = Graph(dtype)
        self.params: List[torch.Tensor] = []
        self.hoisted: Dict[int, Tuple[int, torch.Tensor]] = {}
        self.reductions: List[Vec] = []
        self.red_index: Dict[tuple, int] = {}
        self.products: List[Product] = []
        self.mv_index: Dict[tuple, int] = {}
        self.stages: List[Tuple[str, int]] = []  # ("red", r) and ("mv", m), in trace order
        self.red_kind: List[str] = []  # each reduction's "sum" or "max"

    # -- conversions ---------------------------------------------------------
    def refuse(self, node, why):
        name = node.target if node.op != "call_function" else _opname(node)
        return Bad(_refuse(f"aten.{name} at node {node.name}: {why}"))

    def hoist(self, t: torch.Tensor, key=None) -> int:
        """``t``'s offset in the params vector, rounded to the run's dtype
        (keyed by ``t``, which ``hoisted`` keeps alive so that no other
        tensor takes its id, or by ``key``)."""
        key = id(t) if key is None else key
        if key not in self.hoisted:
            offset = sum(p.numel() for p in self.params)
            self.hoisted[key] = (offset, t)
            self.params.append(t.detach().to(self.dtype).to(torch.float64).reshape(-1).cpu())
        return self.hoisted[key][0]

    def const_vec(self, t: torch.Tensor) -> Vec:
        """A constant vector: literal pieces where it has a few runs of equal
        values (a mask, a one-hot gradient term), else one hoisted
        parameter piece."""
        n = t.shape[0]
        vals = t if t.dtype == torch.bool else t.to(self.dtype)
        runs, a = [], 0
        for p in range(1, n + 1):
            if p == n or not _same(vals[p], vals[a]):
                runs.append((a, p, vals[a].item()))
                a = p
        if t.dtype == torch.bool or len(runs) <= MAX_RUNS:
            return Vec(n, tuple(Piece(a, p, None, self.b.lit(c)) for a, p, c in runs))
        return Vec(n, (Piece(0, n, 0, self.b.mk("prm", attr=self.hoist(t))),))

    def scalar(self, v, node):
        """A 0-d value as a chain node (or Bad)."""
        if isinstance(v, Bad):
            return v
        if isinstance(v, Node):
            return v
        if isinstance(v, (bool, int, float)):
            return self.b.lit(v if isinstance(v, bool) else float(v))
        if isinstance(v, torch.Tensor):
            if v.numel() != 1:
                return self.refuse(node, f"a constant of shape {tuple(v.shape)}")
            x = v.reshape(())
            return self.b.lit(bool(x) if v.dtype == torch.bool else float(x.to(self.dtype)))
        if isinstance(v, Vec) and v.n == 1:
            return self.element(v, 0, node)
        return self.refuse(node, "a vector where a scalar is read")

    def element(self, v: Vec, p: int, node):
        for pc in v.pieces:
            if pc.a <= p < pc.b:
                if pc.off is None:
                    return pc.e
                try:
                    return self.b.pin(pc.e, p + pc.off)
                except _FarRead:
                    return self.refuse(node, "it reads one element of a matrix "
                                       "product as a chain value; the kernels read a "
                                       "product's rows at a vector's indices")
        raise AssertionError("position outside the vector")

    def as_vec(self, v, n, node):
        if isinstance(v, Vec):
            if v.n == n:
                return v
            if v.n == 1:
                e = self.element(v, 0, node)
                return e if isinstance(e, Bad) else Vec(n, (Piece(0, n, None, e),))
            return self.refuse(node, f"lengths {v.n} and {n} do not broadcast")
        if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == n:
            return self.const_vec(v)
        e = self.scalar(v, node)
        return e if isinstance(e, Bad) else Vec(n, (Piece(0, n, None, e),))

    # -- elementwise ---------------------------------------------------------
    def ew(self, node, op, vals, build):
        """``build(*nodes)`` over aligned pieces of ``vals``."""
        for v in vals:
            if isinstance(v, Bad):
                return v
        for v in vals:
            if isinstance(v, torch.Tensor) and _nonunit(v.shape) > 1:
                return self.refuse(node, f"a value of shape {tuple(v.shape)} couples "
                                   "coordinates")
        vals = [v.reshape(-1) if isinstance(v, torch.Tensor) and v.dim() > 1 else v
                for v in vals]
        if not any(isinstance(v, (Vec, Node)) for v in vals):
            return None  # all constant: the caller computes it
        ns = [v.n for v in vals if isinstance(v, Vec)] + [
            v.shape[0] for v in vals if isinstance(v, torch.Tensor) and v.dim() == 1]
        if not ns:
            es = [self.scalar(v, node) for v in vals]
            bad = next((e for e in es if isinstance(e, Bad)), None)
            return bad or build(*es)
        n = max(ns)
        vecs = [self.as_vec(v, n, node) for v in vals]
        bad = next((v for v in vecs if isinstance(v, Bad)), None)
        if bad:
            return bad
        cuts = sorted({0, n} | {c for v in vecs for pc in v.pieces for c in (pc.a, pc.b)})
        pieces = []
        for a, b_ in zip(cuts, cuts[1:]):
            if a == b_:
                continue
            parts = [next(pc for pc in v.pieces if pc.a <= a < pc.b) for v in vecs]
            # one index i for the pieces: a parameter read at i / K stays at its
            # own, then a product's element; every other read moves to i (a
            # neighbour of it, a product's row i - c)
            fixed = {pc.off for pc in parts if pc.off is not None and pc.e.fixed}
            if len(fixed) > 1:
                return self.refuse(node, "it combines a flattened matrix's parameter read at "
                                   f"index i with one at i + {max(fixed) - min(fixed)}")
            own = {pc.off for pc in parts if pc.off is not None and pc.e.own_row}
            off = fixed.pop() if fixed else min(own) if own else next(
                (pc.off for pc in parts if pc.off is not None), None)
            es = [pc.e if pc.off is None else self.b.shift(pc.e, off - pc.off)
                  for pc in parts]
            e = build(*es)
            if e.space == "mixed":
                return self.refuse(node, "it combines rows of products of different lengths")
            pieces.append(Piece(a, b_, off if e.lane else None, e))
        return Vec(n, _merge(pieces))

    # -- reductions ----------------------------------------------------------
    def reduce(self, node, v, kind="sum"):
        """The sum (``kind`` ``"sum"``) or the max (``"max"``) of a vector: a
        stage, or for at most :data:`KMAX` chain values (a stack of a
        mixture's components), a fold of them at lowering time."""
        if isinstance(v, Bad):
            return v
        if isinstance(v, Node):
            return v
        if v.n == 0:
            return self.b.lit(0.0 if kind == "sum" else -math.inf)
        pieces = tuple(v.pieces)
        if v.n <= KMAX and all(pc.off is None for pc in pieces):
            es = [pc.e for pc in pieces for _ in range(pc.a, pc.b)]
            acc = es[0]
            for e in es[1:]:
                acc = self.combine(kind, acc, e)
            return acc
        space = self.space_of(node, pieces, v.n)
        if isinstance(space, Bad):
            return space
        pieces = self.rows0(node, pieces, space)
        if isinstance(pieces, Bad):
            return pieces
        key = (kind,) + tuple((pc.a, pc.b, pc.off, pc.e.id) for pc in pieces)
        if key not in self.red_index:
            self.red_index[key] = len(self.reductions)
            self.stages.append(("red", len(self.reductions)))
            self.reductions.append(Vec(v.n, pieces))
            self.red_kind.append(kind)
        return self.b.mk("red", attr=self.red_index[key])

    def combine(self, kind, acc: Node, e: Node) -> Node:
        """One step of a fold: ``acc + e``, or the max that keeps ``acc``
        unless ``e`` is larger (or a NaN over a number), so that the first of
        equal values gives the value and its tangent."""
        b = self.b
        if kind == "sum":
            return b.mk("add", acc, e)
        take = b.mk("or", b.mk("gt", e, acc), b.mk("and", b.mk("ne", e, e), b.mk("eq", acc, acc)))
        return b.mk("where", take, e, acc)

    def fold(self, node, kind, vecs):
        """Vectors of one length combined position by position (a reduction
        along a matrix's short axis)."""
        acc = vecs[0]
        for v in vecs[1:]:
            acc = self.ew(node, kind, [acc, v], lambda a, e: self.combine(kind, a, e))
            if isinstance(acc, Bad):
                return acc
        return acc

    def space_of(self, node, pieces, n):
        """The index space a sum or a product's input runs over: the one its
        pieces read (the coordinates, or the rows of a data vector, which
        coordinates read at the same index join), else the coordinates for
        ``n == d`` and the rows of length ``n`` otherwise."""
        spaces = {pc.e.space for pc in pieces if pc.e.space is not None}
        if len(spaces) == 2 and "c" in spaces:
            spaces.discard("c")
        if "mixed" in spaces or len(spaces) > 1:
            return self.refuse(node, "it adds rows of products of different lengths in one "
                               "sum")
        return spaces.pop() if spaces else ("c" if n == self.d else n)

    def rows0(self, node, pieces, space):
        """A data vector's pieces moved to offset 0 (its rows' index is the
        position: a sum or a product walks it whole from row 0)."""
        if space == "c":
            return pieces
        if any(pc.off not in (None, 0) and pc.e.fixed for pc in pieces):
            return self.refuse(node, "a slice of a flattened matrix's rows that does not "
                               "start at row 0")
        return tuple(pc if pc.off in (None, 0) else Piece(pc.a, pc.b, 0, self.b.shift(
            pc.e, -pc.off)) for pc in pieces)

    # -- products with a constant matrix ---------------------------------------
    def hoist_matrix(self, M: torch.Tensor):
        """``(offset, colmajor)`` of a constant matrix in the params: the
        matrix as it lies in memory (a transposed view's base, so that ``X``
        and ``X.T`` share one block), keyed by its values in the run's dtype
        (so that the copies ``X.to(x)`` makes at each call share it too)."""
        if M.is_contiguous():
            base, colmajor = M, False
        elif M.t().is_contiguous():
            base, colmajor = M.t(), True
        else:
            base, colmajor = M.contiguous(), False
        vals = base.detach().to(self.dtype).cpu().contiguous()
        key = ("matrix", tuple(vals.shape), hashlib.sha256(vals.numpy().tobytes()).hexdigest())
        return self.hoist(base, key), colmajor

    def product(self, node, M, u):
        """``M u`` for a constant ``(rows, cols)`` matrix and a vector of the
        chain (or Bad): from the coordinates or a data vector's rows, into
        the coordinates or other data rows (read at the coordinates where
        they are placed there, ``X.T @ r`` into a slice of x)."""
        if isinstance(u, Bad):
            return u
        if not isinstance(M, torch.Tensor) or M.dim() != 2:
            return self.refuse(node, "a product whose matrix depends on x")
        rows, cols = M.shape
        if isinstance(u, torch.Tensor):
            if u.dim() > 1 and _nonunit(u.shape) > 1:
                return self.refuse(node, f"a constant of shape {tuple(u.shape)}")
            u = u.reshape(-1)
        u = self.as_vec(u, cols, node)
        if isinstance(u, Bad):
            return u
        in_space = ("c" if not any(_leaves(pc.e) & _PRODUCT_LEAVES for pc in u.pieces)
                    else self.space_of(node, u.pieces, cols))
        if isinstance(in_space, Bad):
            return in_space
        pieces = self.rows0(node, u.pieces, in_space)
        if isinstance(pieces, Bad):
            return pieces
        u = Vec(u.n, pieces)
        space = "c" if rows == self.d else rows
        moff, colmajor = self.hoist_matrix(M)
        return self._stage(Product(rows, cols, moff, colmajor, u, space, in_space))

    def _stage(self, pr: Product) -> Vec:
        """The product's stage (one per matrix and input) and its output:
        an input over the coordinates of degree at most 1 in ``t`` makes
        an output affine in the point too."""
        key = (pr.scan, pr.moff, pr.colmajor, pr.rows, pr.cols,
               tuple((pc.a, pc.b, pc.off, pc.e.id) for pc in pr.vec.pieces))
        if key not in self.mv_index:
            m = self.mv_index[key] = len(self.products)
            self.b.mv_space[m] = pr.space
            if all(pc.e.deg <= 1 for pc in pr.vec.pieces):
                self.b.mv_affine.add(m)
            self.stages.append(("mv", m))
            self.products.append(pr)
        e = self.b.mk("mv", attr=self.mv_index[key])
        return Vec(pr.rows, (Piece(0, pr.rows, 0, e),))

    # -- running sums, flips and periodic shifts ------------------------------
    def _scan_op(self, node, name, args, kwargs):
        """``cumsum``, ``flip`` and ``roll`` of a vector along the coordinates,
        or of a matrix (``flip``, ``roll``) along either axis; a dimension of
        size 1 is left as it is."""
        v = args[0]
        shape = _shape(node.args[0])
        if shape is None:
            return self.refuse(node, "a value of unknown shape")
        shifts = [0]
        if name == "flip":
            dims = list(args[1])
        elif name == "roll":
            shifts = [args[1]] if isinstance(args[1], int) else list(args[1])
            dims = args[2] if len(args) > 2 else kwargs.get("dims", [])
            dims = [dims] if isinstance(dims, int) else list(dims or [])
            if not dims:  # a roll of the flattened value
                if _nonunit(shape) > 1:
                    return self.refuse(node, "a roll of a matrix without dims")
                dims = [next((k for k, n in enumerate(shape) if n != 1), 0)]
        else:
            dims = [args[1] if len(args) > 1 else kwargs["dim"]]
        steps = [(dim % max(1, len(shape)), shifts[k % len(shifts)])
                 for k, dim in enumerate(dims) if shape and shape[dim % len(shape)] != 1]
        for dim, shift in steps:
            if isinstance(v, Mat):
                v = self._mat_move(node, name, v, shape, dim, shift)
            elif isinstance(v, Node):
                return self.refuse(node, f"{name} of a scalar")
            elif name == "cumsum":
                v = (self._rev(node, self.scan(node, v.vec, "suffix")) if isinstance(v, Rev)
                     else self.scan(node, v, "prefix"))
            elif name == "flip":
                v = v.vec if isinstance(v, Rev) else self._reverse(node, v)
            else:
                v = self._unrev(node, v)
                v = v if isinstance(v, Bad) else self._roll(node, v, shift)
            if isinstance(v, Bad):
                return v
        return v

    def _rev(self, node, v):
        return v if isinstance(v, Bad) else Rev(v, node)

    def _unrev(self, node, v):
        """A :class:`Rev` read by an op other than ``cumsum`` and ``flip``:
        the flipped vector itself, its stages read at the flipped rows; any
        other value (lists of them too) as it is."""
        if isinstance(v, Rev):
            return self._reverse(v.node, v.vec, force=True)
        if type(v) in (list, tuple):
            return type(v)(self._unrev(node, x) for x in v)
        return v

    def _mat_move(self, node, name, m: Mat, shape, dim, shift):
        """A flip or a roll of a matrix: along its unrolled axis its vectors
        relabelled at lowering time, along the other each vector's pieces
        moved."""
        if name == "cumsum":
            return self.refuse(node, "a running sum of a matrix")
        i0, i1 = [k for k, n in enumerate(shape) if n != 1]
        vecs = list(m.vecs)
        K = len(vecs)
        if dim == (i0 if m.kfirst else i1):
            vecs = vecs[::-1] if name == "flip" else [vecs[(k - shift) % K] for k in range(K)]
            return m._replace(vecs=tuple(vecs))
        out = [self._unrev(node, self._reverse(node, v)) if name == "flip"
               else self._roll(node, v, shift) for v in vecs]
        bad = next((v for v in out if isinstance(v, Bad)), None)
        return bad or m._replace(vecs=tuple(out))

    def _reverse(self, node, v: Vec, force=False):
        """``flip(v)``: position ``p`` reads ``v``'s ``n - 1 - p``, a lane
        expression's reads of ``x`` becoming reads of coordinate ``c - i``
        (``ya`` with stride -1), its parameters a hoisted reversed copy; a
        vector that reads a stage's output is a :class:`Rev` (unless
        ``force``), and with ``force`` such a piece, or one that reads
        through an index table, is read at its reversed indices as a gather
        reads (:meth:`_regather`)."""
        n, pieces = v.n, []
        params = torch.cat(self.params) if self.params else None
        for pc in v.pieces:
            a, b = n - pc.b, n - pc.a
            if pc.off is None:
                pieces.append(Piece(a, b, None, pc.e))
                continue
            ops = {x.op for x in _nodes(pc.e)}
            if ops & _PRODUCT_LEAVES and not force:
                return self._rev(node, v)
            if ops & {"sel", "prmd"}:
                return self.refuse(node, "a flip of a flattened (n, K) matrix's rows")
            if "seg" in ops:
                return self.refuse(node, "a flip of a scatter-add's output")
            c = n - 1 + pc.off  # the index read before, at the new index i = p
            if ops & (_INDEXED | _PRODUCT_LEAVES):
                e = self._regather(node, pc.e, c - torch.arange(a, b))
                if isinstance(e, Bad):
                    return e
                pieces.append(Piece(a, b, -a, e))
                continue

            def leaf(x, c=c, a=a, b=b):
                if x.op in ("y", "w", "yo", "wo"):
                    return self.b.affine(x.op[0], -1, c + (x.attr or 0))
                if x.op in ("ya", "wa"):
                    st, c2 = x.attr
                    return self.b.affine(x.op[0], -st, st * c + c2)
                if x.op == "prm":  # prm[attr + c - p] at p in [a, b)
                    lo, hi = x.attr + c - (b - 1), x.attr + c - a + 1
                    rev = params[lo:hi].flip(0)
                    return self.b.mk("prm", attr=self.hoist(rev, ("rev", lo, hi)) - a)
                return None

            pieces.append(Piece(a, b, 0, self.b.relabel(pc.e, leaf, {})))
        return Vec(n, _merge(sorted(pieces, key=lambda pc: pc.a)))

    def _roll(self, node, v: Vec, shift: int):
        """``roll(v, shift)``: ``cat(v[n - shift:], v[:n - shift])``, two runs
        of pieces moved to other positions (their reads keep their
        coordinates); a stage's output is refused."""
        n = v.n
        shift %= n
        if shift == 0:
            return v
        if any(pc.e.fixed for pc in v.pieces):
            return self.refuse(node, "a roll of a flattened (n, K) matrix's rows")
        runs = ((_slice(v, n - shift, n), 0), (_slice(v, 0, n - shift), shift))
        pieces = [Piece(pc.a + delta, pc.b + delta, None if pc.off is None else pc.off - delta,
                        pc.e)
                  for part, delta in runs for pc in part.pieces]
        return Vec(n, _merge(pieces))

    def scan(self, node, v, kind: str):
        """The running sum of a vector over the coordinates (``kind``
        ``"prefix"``, or ``"suffix"`` from the last coordinate): a stage, a
        product with the triangular matrix of ones."""
        if isinstance(v, Bad):
            return v
        if not isinstance(v, Vec):
            return self.refuse(node, "a running sum of a scalar")
        if v.n == 1:
            return v
        space = self.space_of(node, v.pieces, v.n)
        if isinstance(space, Bad):
            return space
        if space != "c" or v.n != self.d:
            return self.refuse(node, f"a running sum over {v.n} positions that are not the "
                               f"{self.d} coordinates of x")
        return self._stage(Product(v.n, v.n, -1, False, v, "c", "c", kind))

    def _product(self, node, name, args, kwargs):
        """``mv``, ``mm``/``bmm`` of a constant matrix and a column (or a row
        and a constant matrix), their ``add`` forms, and ``dot``/``vdot``
        (a sum of a product of two vectors)."""
        if name in ("dot", "vdot"):
            prod = self.ew(node, "mul", list(args[:2]), lambda a, c: self.b.mk("mul", a, c))
            if prod is None:
                return node.target(*args, **kwargs)
            return self.reduce(node, prod)
        if name in ("mv", "addmv"):
            M, u = args[-2:] if name == "mv" else args[1:3]
            out = self.product(node, M, u)
        else:
            a, c = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
            sa, sc = _shape(node.args[0 if name in ("mm", "bmm") else 1]), _shape(
                node.args[1 if name in ("mm", "bmm") else 2])
            if name == "bmm" and sa[0] != 1:
                return self._batch(node, a, c, sa, sc)
            if isinstance(a, Mat) or isinstance(c, Mat):
                out = self._mat_product(node, a, c)
                if isinstance(out, Bad) or name == "mm":
                    return out
                if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
                    return self.refuse(node, "a scaled addmm of a matrix of the chain")
                return self._matrix(node, "add", [args[0], out], {}, _shape(node))
            if name == "bmm":
                if sa[0] != 1:
                    return self.refuse(node, f"a batch of {sa[0]} products")
                a = a[0] if isinstance(a, torch.Tensor) else a
                c = c[0] if isinstance(c, torch.Tensor) else c
                sa, sc = sa[1:], sc[1:]
            if sa[1] == 1:  # one term per element: a scalar times a vector
                out = self.ew(node, "mul", [a, c], lambda x, y: self.b.mk("mul", x, y))
            elif sa[0] == 1 and sc[1] == 1:  # a row times a column: a sum
                return self._product(node, "dot", [a, c], {})
            elif isinstance(a, torch.Tensor) and sc[1] == 1:
                out = self.product(node, a, c)        # M (r, c) @ u (c, 1)
            elif isinstance(c, torch.Tensor) and sa[0] == 1:
                out = self.product(node, c.t(), a)    # u (1, c) @ M (c, r) = (M^T u)^T
            elif not isinstance(a, torch.Tensor) and not isinstance(c, torch.Tensor):
                return self.refuse(node, "a product of two vectors of the chain")
            else:
                return self.refuse(node, f"a product of shapes {sa} and {sc} that is not a "
                                   "matrix times a vector")
        if isinstance(out, Bad) or name in ("mv", "mm", "bmm"):
            return out
        bias = args[0]
        beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
        if alpha != 1:
            out = self.ew(node, "mul", [out, alpha], lambda x, y: self.b.mk("mul", x, y))
        if beta != 1:
            bias = (bias * beta if isinstance(bias, torch.Tensor) else
                    self.ew(node, "mul", [bias, beta], lambda x, y: self.b.mk("mul", x, y)))
        return self.ew(node, "add", [bias, out], lambda x, y: self.b.mk("add", x, y))

    # -- the graph -----------------------------------------------------------
    def run(self):
        env = {}
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = Vec(self.d, (Piece(0, self.d, 0, self.b.mk("y")),))
            elif node.op == "get_attr":
                env[node] = getattr(self.gm, node.target)
            elif node.op == "call_function":
                args = [self._arg(a, env) for a in node.args]
                kwargs = {k: self._arg(a, env) for k, a in node.kwargs.items()}
                env[node] = self.call(node, args, kwargs)
            elif node.op == "output":
                out = self._arg(node.args[0], env)
                if type(out) in (tuple, list):
                    out = out[0]
                out = self._unrev(node, out)
            else:
                env[node] = self.refuse(node, f"a graph node of kind {node.op}")
        return out

    def _arg(self, a, env):
        from torch.fx import Node as FxNode

        if isinstance(a, FxNode):
            return env[a]
        if type(a) is tuple:
            return tuple(self._arg(x, env) for x in a)
        if isinstance(a, list):  # fx's immutable_list too
            return [self._arg(x, env) for x in a]
        return a

    def call(self, node, args, kwargs):
        name = _opname(node)
        concrete = all(not isinstance(a, _TRACED) for a in _flat(args)) and all(
            not isinstance(a, _TRACED) for a in _flat(list(kwargs.values())))
        if name == "getitem" and not concrete:  # a value of max.dim's (values, indices)
            return args[0] if isinstance(args[0], Bad) else args[0][args[1]]
        if name in _LIKE:
            return self._like(node, name, args, kwargs)
        inplace = name.endswith("_") and not name.startswith("_")
        if inplace and concrete and isinstance(args[0], torch.Tensor):
            args = [args[0].clone(), *args[1:]]  # never write into a closed-over tensor
        if concrete:
            return node.target(*args, **kwargs)
        if inplace:
            # an in-place op on a value nothing else reads is its functional twin
            src = node.args[0]
            if len(getattr(src, "users", ())) > 1:
                return self.refuse(node, "an in-place op on a value read elsewhere")
            name = name[:-1]
        bad = next((a for a in _flat(args) if isinstance(a, Bad)), None)
        if bad:
            return bad
        if name not in _SCANS | _IDENTITY:
            args = self._unrev(node, args)
            bad = next((a for a in _flat(args) if isinstance(a, Bad)), None)
            if bad:
                return bad
        if name in _SCANS:
            return self._scan_op(node, name, args, kwargs)
        if name in _GATHERS:
            return self._gather(node, name, args)
        if name in _SCATTERS:
            return self._scatter_add(node, name, args, kwargs)
        if name in _COUPLING:
            return self.refuse(node, "it couples coordinates otherwise than the kernels "
                               "read them; they evaluate each coordinate from its own "
                               "value, its neighbours, fixed coordinates, sums, maxes, "
                               "running sums, products of a constant matrix with a vector "
                               "of the chain, and reads and scatter-adds at a constant "
                               "index array")
        shape = _shape(node)
        if name == "max" and len(args) > 1 and isinstance(args[1], (torch.Tensor,) + _TRACED):
            name = "maximum"  # max.other: two values' elementwise max
        if any(isinstance(a, Mat) for a in _flat(args)) or (
                shape is not None and _nonunit(shape) > 1):
            return self._matrix(node, name, args, kwargs, shape)
        if name in _PRODUCTS:
            return self._product(node, name, args, kwargs)
        if name in _RESHAPE:
            return self._reshape(node, name, args)
        if name in ("sum", "mean", "amax", "max"):
            return self._sum(node, name, args, kwargs)
        if name in ("select", "slice", "slice_scatter", "select_scatter", "cat", "stack"):
            return self._move(node, name, args)
        out = self._elementwise(node, name, args, kwargs)
        if out is NotImplemented:
            return self.refuse(node, "an op outside the set the kernels evaluate")
        return out

    def _elementwise(self, node, name, args, kwargs):
        """An elementwise op on vectors and scalars (NotImplemented for any
        other op)."""
        b = self.b
        if name == "copy":  # aten.copy(self, src): src's values
            return args[1]
        if name in _IDENTITY:
            dt = kwargs.get("dtype")
            if dt is not None and dt == torch.bool:
                return self.refuse(node, "a cast to bool")
            v = args[0]
            if dt is not None and dt.is_floating_point and _is_bool(v):
                return self.ew(node, name, [v], lambda a: b.mk("b2f", a))
            return v
        if name in _ELEMENTWISE:
            op = _ELEMENTWISE[name]
            vals = list(args)
            if name in ("add", "sub") and kwargs.get("alpha", 1) != 1:
                alpha = kwargs["alpha"]
                vals[1] = self.ew(node, "mul", [vals[1], alpha],
                                  lambda x, y: b.mk("mul", x, y)) if not isinstance(
                    vals[1], torch.Tensor) else vals[1] * alpha
            if name == "div" and kwargs.get("rounding_mode") is not None:
                return self.refuse(node, f"rounding_mode={kwargs['rounding_mode']!r}")
            return self.ew(node, op, vals, lambda *e: b.mk(op, *e))
        if name in _COMPOUND:
            return self._compound(node, name, args, kwargs)
        return NotImplemented

    def _like(self, node, name, args, kwargs):
        val = node.meta.get("val")
        shape = tuple(val.shape) if val is not None else ()
        dtype = val.dtype if val is not None else self.dtype
        if name == "arange":
            return node.target(*args, **kwargs)
        fill = {"ones_like": 1, "new_ones": 1, "ones": 1}.get(name, 0)
        if name in ("full_like", "full"):
            fill = args[1]
        elif name == "new_full":
            fill = args[2]
        elif name == "scalar_tensor":
            fill = args[0]
        if isinstance(fill, (Vec, Node, Bad)):
            return self.refuse(node, "a fill value that depends on x")
        return torch.full(shape, fill, dtype=dtype, device=self.device)

    def _reshape(self, node, name, args, shape=None):
        """A view of a vector in any shape with at most one dimension past 1
        (``unsqueeze``, ``permute``, the batch views of a product); of a
        vector as a matrix (rows, or strided columns), a broadcast into one;
        of a matrix with its dimensions swapped, or flattened."""
        v = args[0]
        shape = _shape(node) if shape is None else shape
        if shape is None or _nonunit(shape) > 2:
            return self.refuse(node, f"a value of shape {shape} couples coordinates")
        src = (_shape(node.args[0]) if hasattr(node.args[0], "meta")
               else tuple(v.shape) if isinstance(v, torch.Tensor) else ())
        if isinstance(v, Mat):
            if _nonunit(shape) == 2:
                flip = self._swaps(name, args, src, shape)
                if flip is None:
                    return self.refuse(node, f"a reshape of shape {src} to {shape}")
                return v._replace(kfirst=v.kfirst != flip)
            if math.prod(shape) == math.prod(src):
                return self._flatten(node, v)
            return self.refuse(node, f"a reshape of shape {src} to {shape}")
        if _nonunit(shape) == 2:
            return self._to_matrix(node, name, v, src, shape)
        if shape == ():
            return self.scalar(v, node)
        n = math.prod(shape)
        if isinstance(v, Node):
            return Vec(n, (Piece(0, n, None, v),))
        if isinstance(v, Vec) and v.n == n:
            return v
        return self.as_vec(v, n, node)

    def _compound(self, node, name, args, kwargs):
        b = self.b
        one = b.lit(1.0)
        if name == "rsqrt":
            return self.ew(node, name, args[:1], lambda a: b.mk("div", one, b.mk("sqrt", a)))
        if name == "reciprocal":
            return self.ew(node, name, args[:1], lambda a: b.mk("div", one, a))
        if name == "square":
            return self.ew(node, name, args[:1], lambda a: b.mk("mul", a, a))
        if name == "sigmoid":
            return self.ew(node, name, args[:1], lambda a: b.mk(
                "div", one, b.mk("add", one, b.mk("exp", b.mk("neg", a)))))
        if name == "rsub":
            alpha = kwargs.get("alpha", 1)
            return self.ew(node, name, args[:2], lambda a, c: b.mk(
                "sub", c, a if alpha == 1 else b.mk("mul", a, b.lit(alpha))))
        if name == "pow":
            base, ex = args[0], args[1]
            if isinstance(ex, torch.Tensor) and ex.numel() == 1:
                ex = float(ex.reshape(()))
            if not isinstance(ex, (int, float)):
                return self.refuse(node, "an exponent that is not a number")
            return self.ew(node, name, [base], lambda a: b.pow(a, ex))
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        if name == "clamp_max":
            lo, hi = None, args[1]
        if name == "clamp_min":
            lo, hi = args[1], None
        vals, ops = [args[0]], []
        if lo is not None:
            vals.append(lo)
            ops.append("max")
        if hi is not None:
            vals.append(hi)
            ops.append("min")

        def build(a, *bounds):
            for op, c in zip(ops, bounds):
                a = b.mk(op, a, c)
            return a

        return self.ew(node, name, vals, build)

    def _sum(self, node, name, args, kwargs):
        """``sum``, ``mean``, ``amax`` and ``max`` (whole, or ``max.dim``'s
        values; its indices are refused where read) over a vector's or a
        matrix's dimensions."""
        v = args[0]
        shape_in, shape = _shape(node.args[0]), _out_shape(node)
        if shape_in is None or shape is None:
            return self.refuse(node, "a sum of a value of unknown shape")
        kind = "max" if name in ("amax", "max") else "sum"
        dims = args[1] if len(args) > 1 else kwargs.get("dim", [])
        dims = [dims] if isinstance(dims, int) else list(dims or [])
        if isinstance(v, Mat):
            out = self._mat_reduce(node, kind, v, shape_in, dims, shape)
        else:
            out = self._vec_reduce(node, kind, v, shape_in, shape)
        if name == "mean" and not isinstance(out, Bad):
            count = float(math.prod(shape_in) // max(1, math.prod(shape)))
            out = self._elementwise(node, "div", [out, count], {})
        if name == "max" and isinstance(node.meta.get("val"), (tuple, list)):
            return (out, self.refuse(node, "the indices of a max"))
        return out

    def _vec_reduce(self, node, kind, v, shape_in, shape):
        n_in, n_out = math.prod(shape_in), math.prod(shape)
        if isinstance(v, torch.Tensor) and _nonunit(v.shape) > 1:
            return self.refuse(node, f"a value of shape {tuple(v.shape)} couples coordinates")
        if n_out == n_in:  # over dimensions of size 1
            return self._reshape(node, "view", [v], shape)
        if n_out != 1:
            return self.refuse(node, f"a sum over part of a value of shape {shape_in}")
        vec = v.reshape(-1) if isinstance(v, torch.Tensor) else v
        s = self.reduce(node, self.const_vec(vec) if isinstance(vec, torch.Tensor) else vec,
                        kind)
        if shape != () and not isinstance(s, Bad):
            return Vec(1, (Piece(0, 1, None, s),))
        return s

    # -- values with a short axis (Mat) ----------------------------------------
    def _matrix(self, node, name, args, kwargs, shape):
        """An op on or into a value with two dimensions past 1."""
        if shape is not None and _nonunit(shape) > 2:
            return self.refuse(node, f"a value of shape {shape} couples coordinates")
        if name in _PRODUCTS:
            return self._product(node, name, args, kwargs)
        dt = kwargs.get("dtype")
        if name in _RESHAPE or (name in _IDENTITY and (dt is None or (
                dt.is_floating_point and not _is_bool(args[0])))):
            return self._reshape(node, name, args)  # a cast: the run's dtype throughout
        if name in ("sum", "mean", "amax", "max"):
            return self._sum(node, name, args, kwargs)
        if name == "copy" or name in _IDENTITY or name in _ELEMENTWISE or name in _COMPOUND:
            return self._mat_ew(node, name, args, kwargs, shape)
        return self.refuse(node, "an op outside the set the kernels evaluate")

    def _orient(self, node, shape):
        """Whether a new matrix of ``shape`` unrolls its first dimension past 1
        (the shorter one; the first at a tie), or Bad past :data:`KMAX`."""
        a, c = [n for n in shape if n != 1]
        if min(a, c) > KMAX:
            return self.refuse(node, f"a value of shape {tuple(shape)} couples coordinates: "
                               f"its shorter axis ({min(a, c)}) is past KMAX = {KMAX}, the "
                               "most vectors a value's short axis unrolls into")
        return a <= c

    def column(self, t: torch.Tensor):
        """A constant vector of a matrix's part: a scalar where its values
        are equal, else one hoisted parameter piece (so that a flattened
        matrix reads it through ``prmd``); a mask stays a mask."""
        if t.dtype == torch.bool:
            return t
        vals = t.to(self.dtype)
        if bool((vals == vals[0]).all()):
            return vals[0]
        key = ("col", hashlib.sha256(vals.detach().cpu().double().numpy().tobytes()).hexdigest())
        prm = self.b.mk("prm", attr=self.hoist(t, key))
        return Vec(t.shape[0], (Piece(0, t.shape[0], 0, prm),))

    def _flip(self, node, m: Mat):
        """The same matrix unrolled along its other axis, each element a chain
        value (a read of a fixed coordinate, a sum)."""
        n = m.vecs[0].n
        if n > KMAX:
            return self.refuse(node, f"a matrix read along its axis of {n}, past KMAX = {KMAX}")
        vecs = []
        for j in range(n):
            es = [self.element(v, j, node) for v in m.vecs]
            bad = next((e for e in es if isinstance(e, Bad)), None)
            if bad:
                return bad
            vecs.append(Vec(len(es), _merge([Piece(k, k + 1, None, e) for k, e in enumerate(es)])))
        return Mat(tuple(vecs), not m.kfirst)

    def _components(self, node, v, sv, shape, kdim):
        """The ``K`` parts of an operand ``v`` of shape ``sv`` of an op whose
        result has ``shape``, unrolled along dimension ``kdim``."""
        K = shape[kdim]
        sv = (1,) * (len(shape) - len(sv)) + tuple(sv)
        if isinstance(v, Mat):
            if v.kfirst != (kdim == min(i for i, n in enumerate(shape) if n != 1)):
                v = self._flip(node, v)
                if isinstance(v, Bad):
                    return [v] * K
            return list(v.vecs)
        if isinstance(v, torch.Tensor):
            t = v.reshape(sv)
            parts = [t.select(kdim, k if sv[kdim] != 1 else 0) for k in range(K)]
            return [self.column(p.reshape(-1)) if p.numel() > 1 else p.reshape(())
                    for p in parts]
        if isinstance(v, Vec) and v.n > 1 and sv[kdim] == v.n:
            return [self.element(v, k, node) for k in range(K)]
        return [v] * K

    def _mat_ew(self, node, name, args, kwargs, shape):
        """An elementwise op with a matrix operand or result: the op on each of
        the ``K`` parts."""
        dims = [i for i, n in enumerate(shape) if n != 1]
        first = next((a for a in args if isinstance(a, Mat)), None)
        if first is not None:
            kfirst = first.kfirst
        else:
            kfirst = self._orient(node, shape)
            if isinstance(kfirst, Bad):
                return kfirst
        kdim = dims[0] if kfirst else dims[1]
        K, n = shape[kdim], shape[dims[1] if kfirst else dims[0]]
        parts = []
        for j, a in enumerate(args):
            sv = (_shape(node.args[j]) if j < len(node.args) and hasattr(node.args[j], "meta")
                  else tuple(a.shape) if isinstance(a, torch.Tensor) else ())
            parts.append(self._components(node, a, sv or (), shape, kdim))
        vecs = []
        for k in range(K):
            comp = [p[k] for p in parts]
            bad = next((c for c in comp if isinstance(c, Bad)), None)
            if bad:
                return bad
            if all(not isinstance(c, _TRACED) for c in comp):
                out = node.target(*comp, **kwargs)
            else:
                out = self._elementwise(node, name, comp, kwargs)
            if isinstance(out, Bad):
                return out
            out = self.as_vec(out.reshape(-1) if isinstance(out, torch.Tensor) and out.dim()
                              else out, n, node)
            if isinstance(out, Bad):
                return out
            vecs.append(out)
        return Mat(tuple(vecs), kfirst)

    def _to_matrix(self, node, name, v, sv, shape):
        """A vector or a scalar viewed or broadcast into a matrix."""
        kfirst = self._orient(node, shape)
        if isinstance(kfirst, Bad):
            return kfirst
        dims = [i for i, n in enumerate(shape) if n != 1]
        kdim = dims[0] if kfirst else dims[1]
        K, n = shape[kdim], shape[dims[1] if kfirst else dims[0]]
        if isinstance(v, torch.Tensor):
            v = v.reshape(-1) if v.numel() > 1 else v.reshape(())
        if isinstance(v, Vec) and v.n == K * n and name not in ("expand",):
            # a view of the vector: rows are slices, columns strided reads
            if kfirst:
                return Mat(tuple(_slice(v, k * n, (k + 1) * n) for k in range(K)), True)
            cols = [self._restride(node, v, K, k, n) for k in range(K)]
            bad = next((c for c in cols if isinstance(c, Bad)), None)
            return bad or Mat(tuple(cols), False)
        parts = self._components(node, v, sv, shape, kdim)
        vecs = [self.as_vec(p, n, node) for p in parts]
        bad = next((x for x in vecs if isinstance(x, Bad)), None)
        return bad or Mat(tuple(vecs), kfirst)

    def _restride(self, node, v: Vec, K: int, k: int, n: int):
        """Column ``k`` of a vector viewed as an ``(n, K)`` matrix: position
        ``r`` reads the vector's ``K r + k``; a lane expression of x reads
        coordinate ``K r + k`` (``ya``), a parameter a hoisted column."""
        if len(v.pieces) != 1 or v.pieces[0].off is None:
            return self.refuse(node, "a view as an (n, K) matrix of a vector that is not one "
                               "expression of x")
        pc = v.pieces[0]
        if _leaves(pc.e) & _INDEXED:
            return self.refuse(node, "a view as an (n, K) matrix of a gather's or a "
                               "scatter-add's output")
        base = k + pc.off
        params = torch.cat(self.params) if self.params else None

        def leaf(x):
            if x.op in ("y", "w", "yo", "wo"):
                return self.b.mk(f"{x.op[0]}a", attr=(K, base + (x.attr or 0)))
            if x.op in ("ya", "wa"):
                return self.b.mk(x.op, attr=(x.attr[0] * K, x.attr[0] * base + x.attr[1]))
            if x.op == "prm":
                col = params[x.attr + base:x.attr + base + K * (n - 1) + 1:K]
                return self.b.mk("prm", attr=self.hoist(col, ("col", x.attr + base, K, n)))
            if x.op in _PRODUCT_LEAVES or x.op in ("prmd",):
                raise _FarRead()
            return None

        try:
            e = self.b.relabel(pc.e, leaf, {})
        except _FarRead:
            return self.refuse(node, "a strided read of a product's rows")
        return Vec(n, (Piece(0, n, 0, e),))

    def _flatten(self, node, m):
        """A matrix flattened into a vector in row-major order: rows one after
        another (``(K, n)``), or position ``K r + k`` column ``k``'s ``r``
        (``(n, K)``, the generated code picking by ``i % K``)."""
        K, n = len(m.vecs), m.vecs[0].n
        if m.kfirst:
            pieces = []
            for k, v in enumerate(m.vecs):
                for pc in v.pieces:
                    pieces.append(Piece(pc.a + k * n, pc.b + k * n,
                                        None if pc.off is None else pc.off - k * n, pc.e))
            return Vec(K * n, _merge(pieces))
        es = []
        for k, v in enumerate(m.vecs):
            if len(v.pieces) != 1:
                return self.refuse(node, "a flattened (n, K) matrix whose columns are not "
                                   "one expression each")
            e = self._place(node, v.pieces[0], K, k)
            if isinstance(e, Bad):
                return e
            es.append(e)
        e = es[0] if all(x is es[0] for x in es) else self.b.mk("sel", *es, attr=K)
        return Vec(K * n, (Piece(0, K * n, 0, e),))

    def _place(self, node, pc: Piece, K: int, k: int):
        """Column ``k``'s piece of a flattened ``(n, K)`` matrix read at
        position ``K r + k``: its expression at that index.  A product's row
        ``r`` becomes ``mvx``, the column's strided read of x the coordinate
        itself, a parameter ``prmd``."""
        if pc.off is None:
            return pc.e
        if _leaves(pc.e) & _INDEXED:
            return self.refuse(node, "a flattened matrix of a gather's or a scatter-add's "
                               "output")
        off = pc.off

        def leaf(x):
            if x.op in ("mv", "dmv"):
                if off:
                    raise _FarRead()
                return self.b.mk(x.op + "x", attr=(x.attr, K, 0))
            if x.op in ("ya", "wa") and x.attr == (K, k - K * off):
                return self.b.mk(x.op[0])
            if x.op == "prm":
                return self.b.mk("prmd", attr=(x.attr + off, K))
            if x.lane:
                raise _FarRead()
            return None

        try:
            return self.b.relabel(pc.e, leaf, {})
        except _FarRead:
            return self.refuse(node, "a flattened matrix whose rows read other than x's own "
                               "coordinate, parameters and the products' rows")

    def _swaps(self, name, args, src, shape):
        """Whether a view of a matrix swaps its two dimensions past 1 (None: a
        reshape that is not a view of the same two)."""
        i0, i1 = [i for i, n in enumerate(src) if n != 1]
        if name == "permute":
            perm = [p % len(src) for p in args[1]]
            return perm.index(i0) > perm.index(i1)
        if name == "t":
            return True
        same = [n for n in src if n != 1] == [n for n in shape if n != 1]
        return False if same else None

    def _mat_reduce(self, node, kind, m, src, dims, shape):
        i0, i1 = [i for i, n in enumerate(src) if n != 1]
        dims = {d % len(src) for d in dims} if dims else set(range(len(src)))
        kdim, ndim = (i0, i1) if m.kfirst else (i1, i0)
        out = m
        if kdim in dims:
            out = self.fold(node, kind, list(m.vecs))
        if ndim in dims:
            if isinstance(out, Vec):  # both axes: one stage of the folded vector
                return self._vec_reduce(node, kind, out, (out.n,), shape)
            es = [self.reduce(node, v, kind) for v in m.vecs]
            bad = next((e for e in es if isinstance(e, Bad)), None)
            return bad or Vec(len(es), _merge([Piece(k, k + 1, None, e)
                                               for k, e in enumerate(es)]))
        return out

    def _mat_product(self, node, a, c):
        """``mm`` of a constant matrix and a matrix of the chain: a product
        for each of its columns (or rows, on the left)."""
        if isinstance(a, torch.Tensor) and isinstance(c, Mat):
            M, m, kfirst = a, c, False      # M (r, p) @ U (p, K): U's columns
        elif isinstance(c, torch.Tensor) and isinstance(a, Mat):
            M, m, kfirst = c.t(), a, True   # U (K, p) @ M (p, s): M^T U's rows
        else:
            return self.refuse(node, "a product of two values of the chain")
        if m.kfirst != kfirst:
            m = self._flip(node, m)
            if isinstance(m, Bad):
                return m
        vecs = [self.product(node, M, u) for u in m.vecs]
        bad = next((v for v in vecs if isinstance(v, Bad)), None)
        return bad or Mat(tuple(vecs), kfirst)

    def _batch(self, node, a, c, sa, sc):
        """``bmm`` of a batch of ``K <=`` :data:`KMAX` products, one operand a
        constant ``(K, r, p)`` tensor, the other ``K`` vectors of the chain:
        the products side by side, a matrix unrolled along the batch."""
        K = sa[0]
        if K > KMAX:
            return self.refuse(node, f"a batch of {K} products, past KMAX = {KMAX}")
        const_left = isinstance(a, torch.Tensor)
        if const_left == isinstance(c, torch.Tensor) or (sc[2] != 1 if const_left else
                                                         sa[1] != 1):
            return self.refuse(node, f"a batch of {K} products that are not each a "
                               "constant matrix times a vector")
        other = c if const_left else a
        sv = sc if const_left else sa
        if isinstance(other, Mat) and not other.kfirst:
            other = self._flip(node, other)
            if isinstance(other, Bad):
                return other
        us = list(other.vecs) if isinstance(other, Mat) else self._components(
            node, other, sv, sv, 0)
        Ms = [a[k] if const_left else c[k].t() for k in range(K)]
        vecs = [self.product(node, M, u) for M, u in zip(Ms, us)]
        bad = next((v for v in vecs if isinstance(v, Bad)), None)
        return bad or Mat(tuple(vecs), True)

    # -- reads and scatter-adds at a constant index array ----------------------
    def table(self, t: torch.Tensor) -> int:
        """An integer table's offset in the parameters, keyed by its
        entries, which the run's dtype holds exactly (below 2^24, a float32
        mantissa: the callers refuse longer vectors)."""
        t = t.long().cpu().contiguous()
        off = self.hoist(t, ("table", tuple(t.shape),
                             hashlib.sha256(t.numpy().tobytes()).hexdigest()))
        self.b.tables[off] = t
        return off

    def _index(self, node, idx, m):
        """A constant 1-D index into ``m`` positions, negative entries wrapped
        as torch wraps them, as int64 on the host (or Bad)."""
        if isinstance(idx, _TRACED):
            return self.refuse(node, "an index that depends on x; the kernels read at a "
                               "constant index array")
        if not isinstance(idx, torch.Tensor) or idx.dtype in (torch.bool, torch.uint8) or (
                idx.is_floating_point()):
            return self.refuse(node, "an index that is not an integer array (a mask)")
        if idx.dim() > 1:
            return self.refuse(node, f"an index array of shape {tuple(idx.shape)}; the "
                               "kernels read at a 1-D index array")
        idx = idx.reshape(-1).long().cpu()
        idx = torch.where(idx < 0, idx + m, idx)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= m):
            return self.refuse(node, f"an index outside [0, {m})")
        if max(m, idx.numel(), self.d) >= 1 << 24:
            return self.refuse(node, "an index table past 2^24 entries, which a float32 "
                               "parameter holds exactly")
        return idx

    def _gather(self, node, name, args):
        """``v[idx]`` (``index``, ``index_select``, ``gather``, ``take``) of
        a vector of the chain at a constant index: row ``r`` is ``v``'s
        expression at position ``idx[r]``, its reads of x through index
        tables (``yg``), its parameters a gathered hoisted copy."""
        v = args[0]
        if name == "index":
            if len(args[1]) != 1 or args[1][0] is None:
                return self.refuse(node, "an index of more than one dimension")
            idx = args[1][0]
        elif name == "take":
            idx = args[1]
        else:
            if args[1] not in (0, -1):
                return self.refuse(node, f"{name} along dim {args[1]}")
            idx = args[2]
        shape = _shape(node.args[0])
        if not isinstance(v, Vec) or shape is None or _nonunit(shape) > 1:
            return self.refuse(node, "a gather of a value that is not a vector of the chain")
        idx0 = idx
        idx = self._index(node, idx, v.n)
        if isinstance(idx, Bad):
            return idx
        if isinstance(idx0, torch.Tensor) and idx0.dim() == 0:  # one element
            return self.element(v, int(idx), node)
        pcs = [pc for pc in v.pieces if bool(((idx >= pc.a) & (idx < pc.b)).any())]
        n = idx.numel()
        if len(pcs) > 1:
            return self.refuse(node, "a gather across parts of a vector that are different "
                               "expressions")
        if not pcs:
            return Vec(0, ())
        pc = pcs[0]
        if pc.off is None:
            return Vec(n, (Piece(0, n, None, pc.e),))
        e = self._regather(node, pc.e, idx + pc.off)
        return e if isinstance(e, Bad) else Vec(n, (Piece(0, n, 0, e),))

    def _regather(self, node, e: Node, at: torch.Tensor):
        """``e`` read at index ``at[r]`` for row ``r``: each read of a
        coordinate a read through the table of the coordinates it reads
        (``yg``/``wg``), each read of a stage's row one through the table of
        the rows it reads (``mvg``), each parameter a hoisted gathered
        copy."""
        ops = {x.op for x in _nodes(e)}
        if ops & {"sel", "prmd"}:
            return self.refuse(node, "a gather of a flattened (n, K) matrix's rows")
        if "seg" in ops:
            return self.refuse(node, "a gather of a scatter-add's output")
        params = torch.cat(self.params) if self.params else None
        new = {}
        for x in _nodes(e):
            if x.args or not x.lane:
                continue
            if x.op in _PRODUCT_LEAVES:
                m = _stage_of(x.op, x.attr)
                if x.op in ("mv", "dmv"):
                    rows = at
                elif x.op in ("mvx", "dmvx"):
                    rows = (at - x.attr[2]) // x.attr[1]
                else:
                    rows = self.b.tables[x.attr[1]][at + x.attr[3]]
                if int(rows.min()) < 0 or int(rows.max()) >= self.products[m].rows:
                    return self.refuse(node, f"an index that reads rows outside [0, "
                                       f"{self.products[m].rows}) of a product")
                new[x.id] = self.b.mk(("d" if x.op[0] == "d" else "") + "mvg",
                                      attr=(m, self.table(rows), at.numel(), 0))
                continue
            if x.op == "prm":
                vals = params[x.attr + at]
                key = ("gather", x.attr, hashlib.sha256(at.numpy().tobytes()).hexdigest())
                new[x.id] = self.b.mk("prm", attr=self.hoist(vals, key))
                continue
            if x.op in ("yg", "wg"):
                t, _, k = x.attr
                coords = self.b.tables[t][at + k]
            else:  # y, w and their neighbours and strided reads: s i + c
                s, c = x.attr if x.op in ("ya", "wa") else (1, x.attr or 0)
                coords = s * at + c
            if int(coords.min()) < 0 or int(coords.max()) >= self.d:
                return self.refuse(node, f"an index that reads coordinates outside [0, "
                                   f"{self.d})")
            new[x.id] = self.b.mk(x.op[0] + "g", attr=(self.table(coords), at.numel(), 0))
        return self.b.relabel(e, lambda x: new.get(x.id), {})

    def _scatter_add(self, node, name, args, kwargs):
        """``index_put``/``put`` with ``accumulate=True``, ``scatter_add`` and
        ``index_add`` of a vector of the chain at a constant index into a
        vector of at most the ``d`` coordinates: position ``i`` adds the rows
        ``r`` with ``idx[r] = i`` (a segment walk, ``seg``, over the rows
        sorted stably by target, their CSR hoisted as index tables)."""
        if name in ("index_put", "put"):
            base, idx, vals = args[:3]
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            if not acc:
                return self.refuse(node, f"{name} without accumulate: it writes rows without "
                                   "adding them")
            if name == "index_put":
                if len(idx) != 1 or idx[0] is None:
                    return self.refuse(node, "an index of more than one dimension")
                idx = idx[0]
        elif name in ("scatter_add", "index_add"):
            base, dim, idx, vals = args[:4]
            if dim not in (0, -1):
                return self.refuse(node, f"{name} along dim {dim}")
        else:
            return self.refuse(node, "a scatter that writes rows without adding them; the "
                               "kernels add rows (scatter_add, index_add, and index_put and "
                               "put with accumulate=True)")
        shape = _shape(node)
        if shape is None or _nonunit(shape) > 1:
            return self.refuse(node, f"a scatter into a value of shape {shape}")
        m = math.prod(shape)
        if m > self.d:
            return self.refuse(node, f"a scatter into {m} positions, a length other than "
                               f"the {self.d} coordinates of x (or a slice of them)")
        idx = self._index(node, idx, m)
        if isinstance(idx, Bad):
            return idx
        n = idx.numel()
        alpha = kwargs.get("alpha", args[4] if name == "index_add" and len(args) > 4 else 1)
        b = self.b
        if isinstance(vals, torch.Tensor):  # constant rows: a constant scatter
            vals = vals.reshape(-1).expand(n).to(self.dtype).cpu() * alpha
            const = torch.zeros(m, dtype=self.dtype).index_put_((idx,), vals, accumulate=True)
            return self.ew(node, "add", [base, const], lambda a, c: b.mk("add", a, c))
        vals = self.as_vec(vals, n, node)
        if isinstance(vals, Bad):
            return vals
        if alpha != 1:
            vals = self.ew(node, "mul", [vals, alpha], lambda a, c: b.mk("mul", a, c))
        if any("seg" in _leaves(pc.e) for pc in vals.pieces):
            return self.refuse(node, "a scatter-add of a scatter-add's output; the kernels "
                               "walk a segment of rows that read no other segment")
        order = torch.argsort(idx, stable=True)
        ptr = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.cumsum(torch.bincount(idx, minlength=m), 0)])
        spans = tuple((pc.a, pc.b, pc.off) for pc in vals.pieces)
        e = b.mk("seg", *(pc.e for pc in vals.pieces),
                 attr=(self.table(ptr), self.table(order), m, n, spans, 0))
        out = Vec(m, (Piece(0, m, 0, e),))
        if isinstance(base, torch.Tensor) and not bool(base.any()):
            return out
        return self.ew(node, "add", [base, out], lambda a, c: b.mk("add", a, c))

    def _move(self, node, name, args):
        b = self.b
        if name in ("cat", "stack"):
            parts = args[0]
            dim = args[1] if len(args) > 1 else 0
            if dim not in (0, -1) or (name == "stack" and dim != 0):
                return self.refuse(node, f"{name} along dim {dim}")
            vecs = []
            for v in parts:
                if name == "stack":
                    v = self.scalar(v, node)
                    v = v if isinstance(v, Bad) else Vec(1, (Piece(0, 1, None, v),))
                elif isinstance(v, torch.Tensor):
                    v = self.const_vec(v) if v.dim() == 1 else self.refuse(
                        node, f"a constant of shape {tuple(v.shape)}")
                elif isinstance(v, Node):
                    v = Vec(1, (Piece(0, 1, None, v),))
                if isinstance(v, Bad):
                    return v
                vecs.append(v)
            pieces, s = [], 0
            for v in vecs:
                pieces += [Piece(pc.a + s, pc.b + s, None if pc.off is None else pc.off - s,
                                 pc.e) for pc in v.pieces]
                s += v.n
            return Vec(s, _merge(pieces))
        v = args[0]
        if isinstance(v, Node):
            return self.refuse(node, f"{name} of a scalar")
        if isinstance(v, torch.Tensor):
            if v.dim() != 1:
                return self.refuse(node, f"a constant of shape {tuple(v.shape)}")
            v = self.const_vec(v)
        scatter = name in ("slice_scatter", "select_scatter")
        dim = args[2 if scatter else 1] if len(args) > (2 if scatter else 1) else 0
        shape_in = _shape(node.args[0])
        if not scatter and shape_in is not None and len(shape_in) > 1:
            # a vector held as a column or a row: a dimension of size 1 is
            # read whole, the other is the vector's own
            if shape_in[dim % len(shape_in)] == 1:
                if _shape(node) is None or math.prod(_shape(node)) != v.n:
                    return self.refuse(node, f"an empty {name}")
                return v
            dim = 0
        if dim not in (0, -1):
            return self.refuse(node, f"{name} along dim {dim}")
        if name == "select":
            return self.element(v, args[2] + v.n if args[2] < 0 else args[2], node)
        if name == "select_scatter":
            src = self.scalar(args[1], node)
            if isinstance(src, Bad):
                return src
            p = args[3] if len(args) > 3 else 0
            p = p + v.n if p < 0 else p
            return self._scatter(v, Vec(1, (Piece(0, 1, None, src),)), p, p + 1)
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        if name == "slice_scatter":
            src = args[1]
            start, end = (args[3] if len(args) > 3 else None,
                          args[4] if len(args) > 4 else None)
            step = args[5] if len(args) > 5 else 1
        if step != 1:
            return self.refuse(node, f"a slice with step {step}")
        lo, hi, _ = slice(start, end).indices(v.n)
        hi = max(hi, lo)
        if name == "slice":
            pieces = [Piece(max(pc.a, lo) - lo, min(pc.b, hi) - lo,
                            None if pc.off is None else pc.off + lo, pc.e)
                      for pc in v.pieces if pc.a < hi and pc.b > lo]
            return Vec(hi - lo, tuple(pieces))
        src = self.as_vec(src, hi - lo, node)
        if isinstance(src, Bad):
            return src
        return self._scatter(v, src, lo, hi)

    def _scatter(self, v: Vec, src: Vec, lo: int, hi: int) -> Vec:
        pieces = [Piece(pc.a, min(pc.b, lo), pc.off, pc.e) for pc in v.pieces if pc.a < lo]
        pieces += [Piece(pc.a + lo, pc.b + lo, None if pc.off is None else pc.off - lo, pc.e)
                   for pc in src.pieces]
        pieces += [Piece(max(pc.a, hi), pc.b, pc.off, pc.e) for pc in v.pieces if pc.b > hi]
        return Vec(v.n, _merge(pieces))


_INDEXED = {"yg", "wg", "seg"}
"""A gather's reads and a scatter-add: nodes whose index reads a table."""

_NOT_MOMENTS = _FAR | _PRODUCT_LEAVES | {"seg"}
"""Reads that keep a sum off K1's and K6's chain moments, whose Taylor terms
read each coordinate's own ``x`` and ``v`` and coordinates 0 and 1 alone."""

_TRACED = (Vec, Node, Bad, Mat, Rev)
"""The interpreter's values that depend on x (or failed to)."""


def _out_shape(node):
    """A node's shape, or its first value's for an op of several (``max.dim``)."""
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)) and val:
        val = val[0]
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


def _slice(v: Vec, lo: int, hi: int) -> Vec:
    """Positions ``[lo, hi)`` of a vector."""
    return Vec(hi - lo, tuple(Piece(max(pc.a, lo) - lo, min(pc.b, hi) - lo,
                                    None if pc.off is None else pc.off + lo, pc.e)
                              for pc in v.pieces if pc.a < hi and pc.b > lo))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, bit for bit (a NaN equals a NaN, -0 is not 0)."""
    if a.dtype == torch.bool:
        return bool(a == b)
    return a.reshape(1).view(torch.uint8).tolist() == b.reshape(1).view(torch.uint8).tolist()


def _merge(pieces) -> tuple:
    """Adjacent pieces of one expression at one offset as one piece."""
    out: List[Piece] = []
    for pc in pieces:
        if pc.a >= pc.b:
            continue
        if out and out[-1].e is pc.e and out[-1].off == pc.off and out[-1].b == pc.a:
            out[-1] = Piece(out[-1].a, pc.b, pc.off, pc.e)
        else:
            out.append(pc)
    return tuple(out)


def _flat(xs):
    for x in xs:
        if type(x) in (list, tuple):
            yield from _flat(x)
        else:
            yield x


def _is_bool(v) -> bool:
    if isinstance(v, Node):
        return v.boolean
    if isinstance(v, Vec):
        return all(pc.e.boolean for pc in v.pieces)
    if isinstance(v, Mat):
        return all(_is_bool(x) for x in v.vecs)
    return isinstance(v, torch.Tensor) and v.dtype == torch.bool


def _opname(node) -> str:
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(target, "__name__", str(target))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def trace(grad_fn, d: int, dtype, device="cpu"):
    """``make_fx`` of a per-chain gradient on a ``(d,)`` example, in core aten
    ops (dense products kept whole), dead code removed."""
    from torch.fx.experimental.proxy_tensor import make_fx

    example = torch.zeros(d, dtype=dtype, device=device)
    try:
        gm = make_fx(grad_fn, decomposition_table=_decompositions(), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(example)
    except Exception as e:  # noqa: BLE001 (any failure to trace is a refusal)
        raise _refuse(f"tracing it with make_fx failed ({type(e).__name__}: "
                      f"{str(e).splitlines()[0] if str(e) else ''}); a branch on a value "
                      "of x cannot be traced") from e
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def lower_gradient(grad_fn, kernel: str, d: int, dtype, device="cpu") -> Lowered:
    """Lower ``grad_fn`` (one chain's ``(d,) -> (d,)`` gradient) for
    ``kernel`` (``"zigzag"``, ``"sticky"``, ``"suzz"``, ``"bps"``,
    ``"boomerang"``, ``"ecmc"``) at dimension ``d`` in ``dtype``, traced on
    ``device`` (where its closed-over tensors lie); raises
    :class:`LoweringError`."""
    if kernel not in SOURCES:
        raise ValueError(f"no chunk kernel {kernel!r}")
    interp = _Interp(trace(grad_fn, d, dtype, device), d, dtype, device)
    out = interp.run()
    if isinstance(out, Bad):
        raise out.err
    if isinstance(out, torch.Tensor):
        if tuple(out.shape) != (d,):
            raise _refuse(f"the gradient has shape {tuple(out.shape)}, not ({d},)")
        out = interp.const_vec(out)
    elif isinstance(out, Node):
        out = Vec(d, (Piece(0, d, None, out),))
    if not isinstance(out, Vec) or out.n != d:
        raise _refuse(f"the gradient is not a ({d},) vector")
    pieces = []
    for pc in out.pieces:
        if pc.off not in (None, 0):
            if pc.e.fixed:
                raise _refuse(f"gradient coordinates [{pc.a}, {pc.b}) read a flattened "
                              f"matrix's parameter at coordinate i + {pc.off}")
            pc = Piece(pc.a, pc.b, 0, interp.b.shift(pc.e, -pc.off))
        pc = pc._replace(e=_to_coords(interp.b, pc.e, {}))
        if pc.e.space not in (None, "c"):
            raise _refuse(f"gradient coordinates [{pc.a}, {pc.b}) read rows of products of "
                          "different lengths")
        if pc.e.boolean:
            raise _refuse("the gradient is boolean")
        pieces.append(pc)
    # the stages the gradient reads, directly or through other stages (the
    # forward pass leaves others behind); the sums renumbered in order
    def stage_pieces(kind, s):
        return (interp.reductions[s] if kind == "red" else interp.products[s].vec).pieces

    used, todo = set(), [pc.e for pc in pieces]
    while todo:
        for x in _nodes(todo.pop()):
            st = ("mv", _stage_of(x.op, x.attr)) if x.op in _PRODUCT_LEAVES else (x.op, x.attr)
            if x.op in ("red", "mv", "mvx", "mvg") and st not in used:
                used.add(st)
                todo += [pc.e for pc in stage_pieces(*st)]
    order = [st for st in interp.stages if st in used]
    number = {old: new for new, old in enumerate(s for kind, s in order if kind == "red")}
    memo: dict = {}

    def renumber(pc):
        return pc._replace(e=interp.b.relabel(
            pc.e, lambda x: interp.b.mk("red", attr=number[x.attr]) if x.op == "red" else None,
            memo))

    pieces = [renumber(pc) for pc in pieces]
    reductions, red_space, red_kind, products = [], [], [], {}
    for kind, s in order:
        if kind == "red":
            vec = interp.reductions[s]
            reductions.append([renumber(pc) for pc in vec.pieces])
            red_space.append(interp.space_of(None, vec.pieces, vec.n))
            red_kind.append(interp.red_kind[s])
        else:
            pr = interp.products[s]
            products[s] = pr._replace(vec=Vec(pr.vec.n, tuple(renumber(pc)
                                                              for pc in pr.vec.pieces)))
    stages = [("red", number[s]) if kind == "red" else (kind, s) for kind, s in order]
    for summands, space in zip(reductions, red_space):
        for pc in summands:
            lo, hi = _coords(pc)
            if space == "c" and (lo < 0 or hi > d):
                raise _refuse(f"a sum over positions [{pc.a}, {pc.b}) that are not "
                              f"coordinates of x")
    rows = {m: pr.rows for m, pr in products.items()}
    for pc in [*pieces, *(pc for r in reductions for pc in r),
               *(pc for pr in products.values() for pc in pr.vec.pieces)]:
        check_reads(pc, d, rows)
    params = (torch.cat(interp.params) if interp.params
              else torch.zeros(0, dtype=torch.float64))
    return Lowered(interp.b, kernel, d, dtype, pieces, stages, reductions, red_space,
                   products, params, red_kind)


def check_reads(pc: Piece, d: int, rows=None) -> None:
    """Raise where a piece reads a coordinate outside ``[0, d)``: its own,
    a neighbour at offset ``k`` of its indices, or a fixed coordinate (a
    correct trace never does: its slices are static); a row outside a
    product's ``rows[m]``; or an index table's entry outside it (a
    gather's table, a scatter-add's segments), whose entries are checked
    where they are made; a scatter-add's rows are checked at their own
    indices."""
    lo, hi = _coords(pc)
    if lo >= hi:
        return
    for x in _nodes(pc.e, rows=False):
        n, k = ((x.attr[1], x.attr[2]) if x.op in ("yg", "wg") else
                (x.attr[2], x.attr[3]) if x.op in ("mvg", "dmvg") else
                (x.attr[2], x.attr[5]) if x.op == "seg" else (None, 0))
        if n is not None and (lo + k < 0 or hi + k > n):
            raise _refuse(f"positions [{pc.a}, {pc.b}) read entries [{lo + k}, {hi + k}) "
                          f"of an index table of {n}")
        if x.op in ("y", "w") and (lo < 0 or hi > d):
            raise _refuse(f"positions [{pc.a}, {pc.b}) read coordinates [{lo}, {hi}), "
                          f"outside [0, {d})")
        if rows is not None and x.op in ("mv", "dmv", "mvx", "dmvx"):
            m, st, c = (x.attr, 1, 0) if x.op in ("mv", "dmv") else x.attr
            ends = ((lo - c) // st, (hi - 1 - c) // st)
            if min(ends) < 0 or max(ends) >= rows[m]:
                raise _refuse(f"positions [{pc.a}, {pc.b}) read rows {ends} of a product "
                              f"of {rows[m]}")
        if x.op == "seg":
            for (a, b, off), e in zip(x.attr[4], x.args):
                check_reads(Piece(a, b, off, e), d, rows)
        if x.op in ("yo", "wo") and (lo + x.attr < 0 or hi + x.attr > d):
            raise _refuse(f"positions [{pc.a}, {pc.b}) read coordinates "
                          f"[{lo + x.attr}, {hi + x.attr}), outside [0, {d})")
        ends = (x.attr[0] * lo + x.attr[1], x.attr[0] * (hi - 1) + x.attr[1]) if x.op in (
            "ya", "wa") else ()
        if ends and (min(ends) < 0 or max(ends) >= d):
            raise _refuse(f"positions [{pc.a}, {pc.b}) read coordinates {x.attr[0]} i "
                          f"{x.attr[1]:+d}, outside [0, {d})")
        if x.op in ("yk", "wk") and not 0 <= x.attr < d:
            raise _refuse(f"positions [{pc.a}, {pc.b}) read x[{x.attr}], outside [0, {d})")


def _to_coords(b: Graph, n: Node, memo: dict) -> Node:
    """``n`` read at the coordinates: a product's element at its own index
    whose rows are data rows (``X.T @ r`` placed into a slice of x) becomes
    a read of its row ``i`` (``mvx``), which lies in no index space; a
    scatter-add's rows, read at their own indices, stay as they are."""
    if n.id not in memo:
        if n.op in ("mv", "dmv") and b.mv_space[n.attr] != "c":
            memo[n.id] = b.mk(n.op + "x", attr=(n.attr, 1, 0))
        elif not n.args or n.op == "seg":
            memo[n.id] = n
        else:
            memo[n.id] = b.mk(n.op, *(_to_coords(b, a, memo) for a in n.args), attr=n.attr)
    return memo[n.id]


def lane_fits(low: Lowered) -> bool:
    """Whether the kernel takes the lowered gradient's per-point context: K6
    keeps it in shared memory (``sticky_max_dim`` reads the limit from its
    build), a lane of the other kernels in at most :data:`LANE_BYTES`; the
    products formed once per transition lie beside the chain's state
    (``scalar_max_dim`` reads K3/K5's limit from the build, K1 has none)."""
    return low.kernel == "sticky" or low.lane_bytes() <= LANE_BYTES


def lane_message(low: Lowered) -> str:
    return (f"the generated potential's per-point context takes {low.lane_bytes()} bytes "
            f"per lane at d={low.d} in {low.dtype}, past the {LANE_BYTES} a lane of the "
            f"{low.kernel} chunk kernel keeps; run it on backend='xla_stream'")


def lower_sampler(sampler, kind: str, d: int, dtype, device="cpu") -> Lowered:
    """The sampler's gradient lowered for its kernel, cached on the sampler by
    (kernel, d, dtype) as JAX caches ``("pallas_grad", kind, dim, tile,
    dtype)``.  The Boomerang's kernel subtracts ``x`` itself, so its
    ``grad_U`` is lowered as it stands, as is the Speed-Up Zig-Zag's (K4
    builds the effective gradient).  The trace runs on ``device``, where
    the gradient's closed-over tensors lie (the CPU where there is no card)."""
    kernel = "sticky" if kind == "zigzag" and sampler.sticky else kind  # K6, else the kind's
    cache = sampler.__dict__.setdefault("_lowered", {})
    key = (kernel, int(d), dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        device = torch.device("cpu")  # deciding a route needs no card
    if key not in cache:
        try:
            cache[key] = lower_gradient(sampler.grad_U, kernel, d, dtype, device)
        except LoweringError as e:
            cache[key] = e
    hit = cache[key]
    if isinstance(hit, LoweringError):
        raise hit
    return hit

