"""Hot-path rule: ``host-transfer-in-hot-loop``.

Flags device->host transfers and host syncs inside functions marked as
part of the per-query serving fast path (decorated with
:func:`filodb_tpu_torch.lint.hotpath.hot_path`, or named in a
module-level ``__hot_path__`` tuple), including their lexically nested
helpers.

Why: a ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.to("cpu")`` /
``np.asarray`` of a CUDA tensor, or a ``torch.cuda.synchronize()`` (or a
stream's or event's ``.synchronize()``), blocks the calling thread until
the card catches up — one stray sync in a per-query path turns
overlapped host/device execution back into lock-step round trips (the
exact regression the serving fast path removed). The checker cannot
prove a tensor lies on the card statically, so the rule is scoped to
explicitly-marked hot functions and every transfer-shaped call inside
them must either go away or carry a
``# graftlint: disable=host-transfer-in-hot-loop (reason)`` pragma
naming the deliberate sync point (e.g. the single amortized per-batch
copy in ``SplitResult.get``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule

register_rule(
    "host-transfer-in-hot-loop", "trace",
    "device->host transfer or host sync (.item()/.cpu()/.tolist()/"
    "np.asarray/torch.cuda.synchronize) inside a @hot_path per-query "
    "function")

# call leaves that pull device data to host (or block on the device)
from filodb_tpu_torch.lint.astwalk import walk_nodes
_TRANSFER_LEAVES = {"asarray", "array", "ascontiguousarray"}
# numpy-module transfer calls need a numpy alias base; these method
# names flag on ANY receiver (CUDA tensors, streams and events are the
# plausible receivers in hot-path code; pragma the exceptions)
_METHOD_LEAVES = {"item", "tolist", "cpu", "synchronize"}


def _dotted(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _module_hot_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__hot_path__" \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) \
                                and isinstance(el.value, str):
                            out.add(el.value)
    return out


def _is_hot(node, hot_names: Set[str]) -> bool:
    if node.name in hot_names:
        return True
    for d in node.decorator_list:
        name = _dotted(d if not isinstance(d, ast.Call) else d.func)
        if name and name.rsplit(".", 1)[-1] == "hot_path":
            return True
    return False


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in walk_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "numpy":
                    out.add(a.asname or a.name.split(".")[0])
    return out


def check_module(mod: ModuleSource) -> Iterable[Finding]:
    hot_names = _module_hot_names(mod.tree)
    np_aliases = _numpy_aliases(mod.tree) | {"np"}
    findings: List[Finding] = []

    hot_fns = []
    for node in walk_nodes(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_hot(node, hot_names):
            hot_fns.append(node)

    def emit(call: ast.Call, fn, what: str) -> None:
        findings.append(Finding(
            rule="host-transfer-in-hot-loop", path=mod.relpath,
            line=call.lineno,
            message=f"{what} inside hot-path function {fn.name!r} "
                    f"syncs device->host on the per-query path",
            context=f"{fn.name}:{what}:{call.lineno}"))

    for fn in hot_fns:
        # nested defs run in the hot path too: walk the whole subtree
        for node in walk_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is not None:
                parts = dotted.split(".")
                if len(parts) >= 2 and parts[0] in np_aliases \
                        and parts[-1] in _TRANSFER_LEAVES:
                    emit(node, fn, f"{dotted}()")
                    continue
                if dotted.endswith("cuda.synchronize"):
                    emit(node, fn, f"{dotted}()")
                    continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _METHOD_LEAVES \
                    and not node.args:
                # method form: x.item() / x.cpu() / x.tolist() /
                # stream.synchronize() — receiver type unknown, flag in
                # hot scope
                emit(node, fn, f".{f.attr}()")
                continue
            if isinstance(f, ast.Attribute) and f.attr == "to" \
                    and any(isinstance(a, ast.Constant) and a.value == "cpu"
                            for a in list(node.args)
                            + [kw.value for kw in node.keywords]):
                emit(node, fn, '.to("cpu")')
    return findings
