"""OBS001 — every explicit H2D upload flows through h2d_bytes accounting.

The observability subsystem's transfer story (``h2d_bytes``, see
``obs/record.py`` and the registry in ``observability.md`` beside this
package) is only as trustworthy as its coverage: one upload that
bypasses the counter and the warm-open / plane-reuse proofs
under-report transfers.  This rule pins the invariant for PyTorch: every
upload in library code must sit in a function that also issues
``trace.add("h2d_bytes", ...)`` (or ``record.add``) — accounting at
issue.  Sites whose bytes are counted by a caller or a downstream
aggregator are point exceptions: pragma or baseline them with the
accounting site named in the reason.

``ast`` cannot see where a tensor lives, so the rule works from
spellings, and these are exactly the ones it takes.

An *upload* is one of:

* ``R.to(...)`` moving to a device — a ``device=`` keyword, or a first
  positional argument that is a device expression — whose receiver
  ``R`` is host data;
* ``R.cuda(...)`` whose receiver is host data;
* ``torch.tensor(...)``, ``torch.as_tensor(...)`` or
  ``torch.asarray(...)`` with a ``device=`` keyword that is a device
  expression: their data is taken as host data (a list, a scalar, a
  numpy array), which is what these constructors are written for;
* ``D.copy_(S, ...)`` whose source ``S`` is host data.

*Host data* is:

* a call that makes a host tensor — ``torch.from_numpy(...)``, and
  ``torch.tensor``/``as_tensor``/``asarray``/``frombuffer`` without a
  device;
* a numpy array: any call under ``np.``/``numpy.``;
* a name bound in the same function, by a plain assignment, to one of
  the two above;
* a parameter of the innermost function holding the call: a function
  that moves or copies its argument to a device is written to take host
  data.  Where its callers pass tensors already on the card, the site
  says so in a pragma.

A *device expression* is a string other than ``"cpu..."``, a
``torch.device(...)`` call whose first argument is not such a string,
and a name or attribute whose last part is ``device`` or ``dev`` or ends
in ``_device``/``_dev`` (``device``, ``self.device``, ``x.device``).  So a
``.to(torch.int32)`` or ``.to(dtype=...)`` is no upload, nor is
``.to("cpu")``, nor an allocation on the device (``torch.zeros(...,
device=dev)``): no host data crosses there.  A receiver the rule does not
take as host data (a tensor returned by another function, a loop
variable) is not followed: its upload, if it is one, is not seen.

Scope: ``crdt_enc_tpu_torch/`` (the scan's whole tree).
"""

from __future__ import annotations

import ast

from ..astutil import (
    assigned_names,
    call_name,
    const_str,
    enclosing,
    func_params,
    walk_in,
)
from ..engine import PKG_PREFIX, SEV_ERROR, Finding, Project, rule

#: constructors that take host data and may place it on a device
_CONSTRUCTORS = {
    "torch.tensor", "torch.as_tensor", "torch.asarray",
}
#: calls whose result is a host tensor (without a ``device=`` keyword)
_HOST_TENSOR_CALLS = _CONSTRUCTORS | {"torch.from_numpy", "torch.frombuffer"}
_NUMPY_PREFIXES = ("np.", "numpy.")
_DEVICE_NAMES = {"device", "dev"}


def _accounts_h2d(scope: ast.AST, *, module_level: bool = False) -> bool:
    """Does ``scope`` issue ``*.add("h2d_bytes", ...)``?  For a module
    scope only module-level statements count — accounting inside some
    unrelated function must not excuse a module-level transfer."""
    if module_level:
        stack = list(getattr(scope, "body", []))
        calls = []
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                calls.append(node)
            stack.extend(ast.iter_child_nodes(node))
    else:
        calls = walk_in(scope, ast.Call)
    for call in calls:
        cn = call_name(call) or ""
        if cn.rsplit(".", 1)[-1] == "add" and call.args:
            if const_str(call.args[0]) == "h2d_bytes":
                return True
    return False


def _keyword(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def is_device_expr(node: ast.AST | None) -> bool:
    """A device spelling (see the module docs); ``"cpu"`` is none."""
    if node is None:
        return False
    s = const_str(node)
    if s is not None:
        return not s.startswith("cpu")
    if isinstance(node, ast.Call):
        if call_name(node) != "torch.device":
            return False
        first = node.args[0] if node.args else _keyword(node, "type")
        s = const_str(first) if first is not None else None
        return s is None or not s.startswith("cpu")
    if isinstance(node, ast.Name):
        last = node.id
    elif isinstance(node, ast.Attribute):
        last = node.attr
    else:
        return False
    return last in _DEVICE_NAMES or last.endswith(("_device", "_dev"))


def _host_call(node: ast.AST) -> bool:
    """A call that makes host data: a host tensor or a numpy array."""
    if not isinstance(node, ast.Call):
        return False
    cn = call_name(node) or ""
    if cn.startswith(_NUMPY_PREFIXES):
        return True
    return cn in _HOST_TENSOR_CALLS and not is_device_expr(
        _keyword(node, "device")
    )


class _HostNames:
    """The names a function binds to host data, and its parameters."""

    def __init__(self, fn):
        self.names: set[str] = set()
        if fn is None:
            return
        self.names.update(p for p in func_params(fn) if p not in ("self", "cls"))
        for a in walk_in(fn, ast.Assign):
            if _host_call(a.value):
                for t in a.targets:
                    self.names.update(assigned_names(t))

    def holds(self, node: ast.AST) -> bool:
        if _host_call(node):
            return True
        return isinstance(node, ast.Name) and node.id in self.names


def _upload(call: ast.Call, host: _HostNames) -> str | None:
    """A description of the upload ``call`` makes, else None."""
    full = call_name(call) or ""
    if full in _CONSTRUCTORS:
        return full if is_device_expr(_keyword(call, "device")) else None
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if func.attr == "to":
        target = _keyword(call, "device")
        if target is None and call.args:
            target = call.args[0]
        if is_device_expr(target) and host.holds(recv):
            return ".to(<device>) of host data"
    elif func.attr == "cuda":
        if host.holds(recv):
            return ".cuda() of host data"
    elif func.attr == "copy_":
        if call.args and host.holds(call.args[0]):
            return "copy_ from host data"
    return None


@rule("OBS001", SEV_ERROR)
def upload_accounted(project: Project):
    """Host-to-device uploads in library code (``.to(<device>)``,
    ``.cuda()``, ``torch.tensor(..., device=)``, ``copy_`` from host
    data) must be h2d_bytes-accounted in the same function."""
    for mod in project.modules:
        if not mod.rel.startswith(PKG_PREFIX):
            continue
        checked: dict[ast.AST, bool] = {}
        hosts: dict[ast.AST | None, _HostNames] = {}
        for call in mod.walk(ast.Call):
            scope = enclosing(mod, call, ast.FunctionDef, ast.AsyncFunctionDef)
            if scope not in hosts:
                hosts[scope] = _HostNames(scope)
            what = _upload(call, hosts[scope])
            if what is None:
                continue
            key = scope if scope is not None else mod.tree
            if key not in checked:
                checked[key] = _accounts_h2d(key, module_level=scope is None)
            if checked[key]:
                continue
            yield Finding(
                rule="OBS001", severity=SEV_ERROR, path=mod.rel,
                line=call.lineno, context=mod.context_of(call),
                message=(
                    f"{what} without h2d_bytes accounting in the same "
                    "function — the transfer is invisible to the "
                    'observability counters; trace.add("h2d_bytes", '
                    "x.nbytes) at issue, or pragma with the accounting "
                    "site named"
                ),
            )
