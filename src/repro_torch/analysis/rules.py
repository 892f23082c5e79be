"""The port's lint rules, RL003 and RL010: two of the standing policies
(ROADMAP.md), mechanically, over the PyTorch port.

* RL003 host-sync-discipline: inside a function marked ``@hot_loop``
  (``repro_torch.serve.diffusion``'s serving loop), no implicit
  device-to-host sync outside the ``_host_fetch`` seam: ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()`` or ``np.asarray()``/``np.array()`` of a tensor, and no
  ``torch.cuda.synchronize()`` at all.  Values are followed by a forward
  taint over the body as JAX's rule follows them: what ``_host_fetch``,
  numpy, ``math`` and builtins return is host, what a ``torch`` call or an
  unknown callee without a host argument returns is a tensor.
* RL010 kernel-tile-literals: no integer literal passed for a tuning knob
  (a parameter of ``repro_torch.kernels.tuning``, or a geometry
  function's argument that carries one) at a call site outside
  ``src/repro_torch/kernels/``: launch and build geometry resolve through
  the tuner, and a candidate goes through ``KernelTuner(overrides=...)``.

Pure AST, stdlib only, like the JAX package's rules.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.core import (Finding, ModuleInfo, module_rule,
                                       qualname)


def _find(mod: ModuleInfo, node: ast.AST, code: str, rule: str,
          message: str) -> Finding:
    return Finding(code=code, message=message, path=mod.path,
                   line=getattr(node, "lineno", 1),
                   col=getattr(node, "col_offset", 0), rule=rule)


# ==========================================================================
# RL003 — host-sync discipline inside @hot_loop
# ==========================================================================

_HOST_MODULES = ("np", "numpy", "math")
_HOST_BUILTINS = frozenset({
    "len", "min", "max", "sum", "sorted", "enumerate", "range", "list",
    "tuple", "dict", "set", "zip", "abs", "any", "all", "str", "repr",
    "print", "isinstance", "getattr", "hasattr", "float", "int", "bool",
    "round", "divmod", "reversed", "map", "filter",
})
_DEVICE_MODULES = ("torch",)
_CONVERTERS = frozenset({"float", "int", "bool"})
_NP_CONVERTERS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                            "numpy.array"})
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize", "torch.synchronize",
                         "torch.cuda.current_stream.synchronize"})


def _is_hot_loop(dec: ast.AST, aliases: Dict[str, str]) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    qn = qualname(target, aliases)
    return bool(qn) and qn.split(".")[-1] == "hot_loop"


def _is_host_fetch(func: ast.AST, aliases: Dict[str, str]) -> bool:
    qn = qualname(func, aliases)
    return bool(qn) and qn.split(".")[-1].endswith("host_fetch")


def _expr_key(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _target_keys(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        base = _expr_key(node)
        return [base] if base else []
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            out.extend(_target_keys(e))
        return out
    if isinstance(node, ast.Starred):
        return _target_keys(node.value)
    return []


class _Taint:
    """Forward host/device taint over one @hot_loop body (JAX's rule's,
    with ``torch`` as the device module)."""

    def __init__(self, aliases: Dict[str, str]):
        self.aliases = aliases
        self.host: Set[str] = set()
        self.device: Set[str] = set()

    def classify(self, node: ast.AST) -> str:          # host|device|unknown
        if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.Set,
                             ast.Dict, ast.ListComp, ast.SetComp,
                             ast.DictComp, ast.GeneratorExp,
                             ast.JoinedStr)):
            return "host"
        key = _expr_key(node)
        if key is not None:
            parts = key.split(".")
            for i in range(len(parts), 0, -1):
                base = ".".join(parts[:i])
                if base in self.device:
                    return "device"
                if base in self.host:
                    return "host"
            return "unknown"
        if isinstance(node, ast.Subscript):
            return self.classify(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.classify(node.operand)
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare, ast.IfExp)):
            kids = [self.classify(k) for k in ast.iter_child_nodes(node)
                    if isinstance(k, ast.expr)]
            if "device" in kids:
                return "device"
            if kids and all(k == "host" for k in kids):
                return "host"
            return "unknown"
        if isinstance(node, ast.Call):
            return self.classify_call(node)
        return "unknown"

    def classify_call(self, node: ast.Call) -> str:
        if _is_host_fetch(node.func, self.aliases):
            return "host"
        qn = qualname(node.func, self.aliases)
        root = qn.split(".")[0] if qn else None
        args = list(node.args) + [kw.value for kw in node.keywords]
        if root in _HOST_MODULES or (isinstance(node.func, ast.Name)
                                     and node.func.id in _HOST_BUILTINS):
            return "host"
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_METHODS:
                return "host"              # flagged where it is called
            if self.classify(node.func.value) == "host":
                return "host"
        if root in _DEVICE_MODULES:
            return "device"
        if "host" in (self.classify(a) for a in args):
            return "host"
        return "device"

    def assign(self, targets: Sequence[ast.AST], value: ast.AST) -> None:
        taint = self.classify(value)
        for t in targets:
            for key in _target_keys(t):
                self.host.discard(key)
                self.device.discard(key)
                if taint in ("host", "device"):
                    getattr(self, taint).add(key)


def _iter_stmts(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements of one scope in source order, into compound statements
    but not into nested function or class scopes."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from _iter_stmts(sub)
        for h in getattr(stmt, "handlers", []) or []:
            yield from _iter_stmts(h.body)


def _stmt_exprs(stmt: ast.stmt) -> Iterable[ast.AST]:
    """The expressions ``stmt`` itself evaluates (a compound statement's
    header only)."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield stmt.target
        yield stmt.iter
    elif isinstance(stmt, (ast.While, ast.If)):
        yield stmt.test
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield item.context_expr
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        yield from stmt.decorator_list
    elif not isinstance(stmt, ast.Try):
        yield stmt


_SEAM = ("route the read through the `_host_fetch` seam (one sync per "
         "refinement)")


@module_rule("RL003", "host-sync-discipline",
             "implicit device->host sync inside a @hot_loop function "
             "outside the _host_fetch seam")
def rl003_host_sync(mod: ModuleInfo) -> Iterable[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_is_hot_loop(d, mod.aliases) for d in node.decorator_list):
            continue
        taint = _Taint(mod.aliases)
        for stmt in _iter_stmts(node.body):
            for expr in _stmt_exprs(stmt):
                for sub in ast.walk(expr):
                    if isinstance(sub, ast.Call):
                        yield from _rl003_check_call(mod, sub, taint)
            if isinstance(stmt, ast.Assign):
                taint.assign(stmt.targets, stmt.value)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) and \
                    stmt.value is not None:
                taint.assign([stmt.target], stmt.value)
            elif isinstance(stmt, ast.For):
                taint.assign([stmt.target], stmt.iter)


def _rl003_check_call(mod: ModuleInfo, call: ast.Call,
                      taint: _Taint) -> Iterable[Finding]:
    qn = qualname(call.func, mod.aliases)
    if qn in _SYNC_CALLS:
        yield _find(mod, call, "RL003", "host-sync-discipline",
                    f"`{qn}()` inside a @hot_loop waits for the card; "
                    f"{_SEAM}")
        return
    args = call.args
    if isinstance(call.func, ast.Name) and call.func.id in _CONVERTERS \
            and len(args) == 1:
        if taint.classify(args[0]) == "device":
            yield _find(mod, call, "RL003", "host-sync-discipline",
                        f"`{call.func.id}()` of a tensor inside a @hot_loop "
                        f"forces an implicit sync; {_SEAM}")
    elif qn in _NP_CONVERTERS and args:
        if taint.classify(args[0]) == "device":
            yield _find(mod, call, "RL003", "host-sync-discipline",
                        f"`{qn}()` of a tensor inside a @hot_loop forces "
                        f"an implicit sync; {_SEAM}")
    elif isinstance(call.func, ast.Attribute) and \
            call.func.attr in _SYNC_METHODS and not args:
        if taint.classify(call.func.value) == "device":
            yield _find(mod, call, "RL003", "host-sync-discipline",
                        f"`.{call.func.attr}()` of a tensor inside a "
                        f"@hot_loop forces an implicit sync; {_SEAM}")


# ==========================================================================
# RL010 — tuning knobs come from the tuner
# ==========================================================================

# The parameters of repro_torch.kernels.tuning (tests hold this set to the
# tuner's) and the geometry functions' arguments that carry them.
RL010_KNOBS = frozenset({
    "ddim_threads", "resid_threads", "resid_max_cluster",
    "resid_slice_per_block", "fwd_block_n", "fwd_stages", "bwd_block_n",
    "bwd_stages", "dv_sum_threads", "fwd_cols", "bwd_rows", "channels",
    "stages", "bwd_channels", "segment_chunks", "max_segments", "bwd_sub",
    "bwd_max_threads", "bwd_min_blocks", "bwd_replay_min_blocks",
})
_RL010_GEOMETRY_ARGS = frozenset({"threads", "max_threads", "max_cluster",
                                  "slice_per_block", "sub"})
_RL010_OWNER = "src/repro_torch/kernels/"


def _int_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and \
            not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _int_literal(node.operand)
    return False


@module_rule("RL010", "kernel-tile-literals",
             "integer literal for a kernel tuning knob outside "
             "repro_torch.kernels: geometry comes from the tuner")
def rl010_tile_literals(mod: ModuleInfo) -> Iterable[Finding]:
    if _RL010_OWNER in mod.path.replace(os.sep, "/"):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if (kw.arg in RL010_KNOBS or kw.arg in _RL010_GEOMETRY_ARGS) \
                    and _int_literal(kw.value):
                yield _find(
                    mod, node, "RL010", "kernel-tile-literals",
                    f"integer literal for the tuning knob `{kw.arg}` at a "
                    f"call site outside repro_torch.kernels: launch and "
                    f"build geometry resolve through "
                    f"repro_torch.kernels.tuning (pass tuner=, or pin a "
                    f"candidate with KernelTuner(overrides=...))")
