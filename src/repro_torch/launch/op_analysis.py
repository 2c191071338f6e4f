"""Operation and byte counts of the port's eager program: the counterpart
of the JAX package's ``launch/hlo_analysis.py``.

The JAX package counts its cells over the optimized HLO text and weights
each op by the trip counts of the while loops around it, because XLA's own
cost analysis counts a loop body once. The port has no HLO: its program is
eager PyTorch, and an eager loop runs every iteration, so ``OpCounter``, a
``TorchDispatchMode``, sees each op as often as it runs and needs no trip
counts. It counts:

  * flops — dot ops only, 2 * prod(output shape) * prod(contracted dims),
    the definition of ``hlo_analysis.py`` (elementwise flops are left out).
    The formulas are ``torch.utils.flop_counter``'s for ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, the convolutions and the attention ops, plus
    ``mv``, ``addmv`` and ``dot``, wherever they dispatch (forward,
    backward, a checkpoint's recompute).
  * bytes — operand plus output bytes of every op that moves data. An op
    whose every output is a view of an input (``view``, ``_unsafe_view``,
    ``expand``, ``t``, ``transpose``, ``permute``, ``slice``, ``select``,
    ``unsqueeze``, ``squeeze``, ``as_strided``, ``alias``, ...; read from
    the op's schema, plus the views it does not mark) and an allocation
    (``empty``) count 0. An operand's bytes are those it addresses: a
    broadcast (stride-0) dimension is read once. An in-place indexed write
    (``index_copy_``, ``index_put_``, ``scatter_``, ...) reads its other
    operands and writes the source's elements, not the whole target, as
    ``hlo_analysis.py`` charges a ``dynamic-update-slice``. These are the
    bytes of the *eager* program, in which each op reads its operands and
    writes its output once, so the number is higher than the fused count
    of the JAX package's HLO and is not compared with it.
  * a per-op breakdown (``by_op``), and with ``log=True`` the sequence of
    (op, flops, bytes), by which two runs compare op by op, and of the dot
    ops with their operand shapes (``dots``);
  * ``peak_live_bytes`` — the peak of the bytes of the tensors the ops
    made and that were still alive (each non-view output from its op until
    its tensor is freed); the program's inputs are not in it.

It works on ``meta``, CPU and CUDA tensors alike: the counts come from
shapes and dtypes, so a ``meta`` run counts a full-width cell with no
memory.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry, shape_wrapper

aten = torch.ops.aten

# ops that move no data: views the schema does not mark as aliases, and
# allocations
_NO_DATA = {aten._unsafe_view, aten._reshape_alias, aten.lift_fresh, aten.detach,
            aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
            aten.new_empty_strided}
# in-place indexed writes: they read their other operands and write the
# source's elements into ``self``, not the whole of ``self``
_INDEXED_WRITES = {aten.index_copy_, aten.index_put_, aten._index_put_impl_,
                   aten.index_add_, aten.scatter_, aten.scatter_add_,
                   aten.scatter_reduce_, aten.masked_scatter_}


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _addmv_flop(self_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


_FLOPS = {**flop_registry, aten.mv: shape_wrapper(_mv_flop),
          aten.addmv: shape_wrapper(_addmv_flop), aten.dot: shape_wrapper(_dot_flop),
          aten.vdot: shape_wrapper(_dot_flop)}


_VIEW: Dict[object, bool] = {}


def _is_view(func) -> bool:
    """Every output of ``func`` aliases an input without writing it."""
    v = _VIEW.get(func)
    if v is None:
        rets = func._schema.returns
        v = _VIEW[func] = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in rets)
    return v


def _leaves(x, out: list) -> list:
    if isinstance(x, (list, tuple)):
        for e in x:
            _leaves(e, out)
    elif isinstance(x, dict):
        for e in x.values():
            _leaves(e, out)
    else:
        out.append(x)
    return out


def _signature(leaves) -> Optional[tuple]:
    """A hashable key of the inputs' metadata (every tensor on ``meta``),
    or None where some input has none."""
    key = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                return None
            key.append((tuple(x.shape), x.stride(), x.dtype))
        else:
            try:
                hash(x)
            except TypeError:
                return None
            key.append((type(x), x))
    return tuple(key)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: its elements, a broadcast (stride-0)
    dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class OpStats:
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class OpCounter(TorchDispatchMode):
    """Counts flops and bytes of every op dispatched inside ``with
    OpCounter() as c:`` (see the module docstring)."""

    def __init__(self, *, log: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, OpStats] = defaultdict(OpStats)
        self.log: Optional[List[Tuple[str, float, int]]] = [] if log else None
        # with log=True, each dot op's (name, operand shapes, flops)
        self.dots: Optional[list] = [] if log else None
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._memo: dict = {}  # meta inputs' signature -> counts and outputs
        self._names: dict = {}  # op -> its name in by_op and the log

    def _release(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _NO_DATA or _is_view(func):  # no data moved, nothing made
            out = func(*args, **kwargs)
            self._add(self._names.get(func) or self._name(func), 0, 0)
            return out
        ins_all = _leaves(args, [])
        if kwargs:
            _leaves(kwargs, ins_all)
        sig = _signature(ins_all)
        key = None if sig is None else (func, sig)
        memo = self._memo.get(key) if key is not None else None
        if memo is None:
            out = func(*args, **kwargs)
            memo = self._account(func, args, kwargs, ins_all, out)
            if key is not None:
                memo_out = self._out_spec(ins_all, out)
                if memo_out is not None:
                    self._memo[key] = (memo, memo_out)
        else:
            memo, (spec, descr) = memo
            out = tree_unflatten([
                ins_all[d[1]] if d[0] == "arg" else
                torch.empty_strided(d[1], d[2], dtype=d[3], device="meta") if d[0] == "new"
                else d[1] for d in descr], spec)
        name, flops, nbytes, made = memo
        if any(made):
            for t, b in zip(_leaves(out, []), made):
                if b:  # a new tensor lives until it is freed
                    self.live_bytes += b
                    weakref.finalize(t, self._release, b)
            if self.live_bytes > self.peak_live_bytes:
                self.peak_live_bytes = self.live_bytes
        self._add(name, flops, nbytes)
        if flops and self.dots is not None:
            self.dots.append((name, tuple(tuple(t.shape) for t in ins_all
                                          if isinstance(t, torch.Tensor)), flops))
        return out

    def _name(self, func) -> str:
        name = self._names[func] = str(func.overloadpacket).replace("aten.", "")
        return name

    def _add(self, name: str, flops: int, nbytes: int) -> None:
        st = self.by_op[name]
        st.count += 1
        st.flops += flops
        st.bytes += nbytes
        self.flops += flops
        self.bytes += nbytes
        if self.log is not None:
            self.log.append((name, flops, nbytes))

    @staticmethod
    def _account(func, args, kwargs, ins_all, out):
        """(name, flops, bytes, the bytes of each new output leaf)."""
        packet = func.overloadpacket
        flops = 0
        if packet in _FLOPS:
            flops = int(_FLOPS[packet](*args, out_val=out, **kwargs))
        out_leaves = _leaves(out, [])
        nbytes = 0
        made = [0] * len(out_leaves)
        if not _is_view(func) and packet not in _NO_DATA:
            ins = [t for t in ins_all if isinstance(t, torch.Tensor)]
            outs = [t for t in out_leaves if isinstance(t, torch.Tensor)]
            if packet in _INDEXED_WRITES:  # ins[0] is the target, ins[-1] the source
                nbytes = sum(tensor_bytes(t) for t in ins[1:]) + tensor_bytes(ins[-1])
            else:
                nbytes = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
            mutated = {id(t) for t in ins}
            made = [t.numel() * t.element_size()
                    if isinstance(t, torch.Tensor) and id(t) not in mutated else 0
                    for t in out_leaves]
        return str(packet).replace("aten.", ""), flops, nbytes, made

    @staticmethod
    def _out_spec(ins_all, out):
        """How to make ``out`` again for the same inputs: its tree and, per
        leaf, the input it is, a new tensor's metadata, or the value; None
        where it cannot be made again."""
        leaves, spec = tree_flatten(out)
        descr = []
        for t in leaves:
            if isinstance(t, torch.Tensor):
                j = next((j for j, x in enumerate(ins_all) if x is t), None)
                if j is not None:
                    descr.append(("arg", j))
                elif t.device.type == "meta":
                    descr.append(("new", tuple(t.shape), t.stride(), t.dtype))
                else:
                    return None
            else:
                descr.append(("value", t))
        return spec, descr

    def costed(self) -> List[Tuple[str, float, int]]:
        """The log without the entries that count nothing (views, and the
        ``lift_fresh`` a CPU or CUDA tensor made from a Python number takes
        and a ``meta`` one does not): what two runs compare op by op."""
        return [e for e in self.log if e[1] or e[2]]

    def breakdown(self, top: Optional[int] = None) -> Dict[str, dict]:
        """{op: {count, flops, bytes}}, the largest bytes first."""
        items = sorted(self.by_op.items(), key=lambda kv: (-kv[1].bytes, -kv[1].flops, kv[0]))
        return {k: dataclasses.asdict(v) for k, v in items[:top]}


def count_ops(fn, *args, log: bool = False, **kwargs):
    """``(fn(*args, **kwargs), OpCounter)``: one call of ``fn`` counted."""
    with OpCounter(log=log) as c:
        out = fn(*args, **kwargs)
    return out, c
