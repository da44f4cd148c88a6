"""Kernel contract rules (KER2xx).

The reference's PAL2xx rules recompute a ``pl.pallas_call`` site's
contracts (grid, BlockSpecs, kernel arity) from Python's AST.  The port's
kernels are CUDA C++ behind a ctypes interface, so most of those contracts
live where Python's AST cannot read them, and two new ones appear at the
boundary:

* KER203 — every ``build.SIGNATURES`` entry matches the ``extern "C"``
  prototype in ``kernels/csrc/<library>.cu``, in count and in each
  parameter's kind (pointer, int, float, stream): PAL203's counterpart
  ("kernel arity").  ctypes passes what the list says, so a mismatch is a
  silent memory fault, not an error;
* KER206 — a wrapper in ``kernels/`` that launches a kernel and returns
  its outputs either refuses autograd (``build.refuse_grad``) or routes
  ``build.needs_grad(...)`` to an ``autograd.Function``'s ``apply``.  A
  ctypes launch writes tensors autograd never saw: without either, their
  gradient is silently zero and the layer trains frozen.

PAL201, PAL202, PAL204 and PAL205 (block shapes against the grid, index
maps, guarded table walks, ``program_id`` ranks) have no Python-side
counterpart: each CUDA launcher computes its grid from the shapes and
refuses a geometry other than its own (``_geometry`` in each wrapper,
checked in C), and ``chip_smoke.py`` holds every kernel against its plain
version at the shapes the main path gives it.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis import astutil as au
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

# ---------------------------------------------------------------------------
# KER203 — ctypes signatures against the CUDA prototypes
# ---------------------------------------------------------------------------

_CTYPES_KIND = {"c_void_p": "pointer", "c_char_p": "pointer",
                "c_int": "int", "c_int32": "int", "c_uint": "int",
                "c_uint32": "int", "c_float": "float", "c_double": "double",
                "c_int64": "int64", "c_uint64": "int64",
                "c_longlong": "int64", "c_size_t": "int64",
                "c_long": "int64"}
_C_KIND = {"int": "int", "unsigned": "int", "unsigned int": "int",
           "int32_t": "int", "uint32_t": "int", "float": "float",
           "double": "double", "int64_t": "int64", "uint64_t": "int64",
           "long long": "int64", "size_t": "int64", "long": "int64"}
_EXTERN_C = re.compile(
    r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _c_kind(param: str) -> str:
    """pointer, stream, int, float, double or int64 for one C parameter."""
    p = re.sub(r"\bconst\b", " ", param).strip()
    if "cudaStream_t" in p or re.search(r"\bstream\s*$", p):
        return "stream"
    if "*" in p:
        return "pointer"
    words = p.split()
    return _C_KIND.get(" ".join(words[:-1]), "unknown " + " ".join(words))


def _prototypes(source: str) -> dict[str, list[tuple[str, str]]]:
    """function -> [(kind, parameter text)] of every ``extern "C"``
    definition in a CUDA source (comments dropped)."""
    source = re.sub(r"//[^\n]*", "", source)
    source = re.sub(r"/\*.*?\*/", "", source, flags=re.S)
    out = {}
    for m in _EXTERN_C.finditer(source):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = [(_c_kind(p), " ".join(p.split())) for p in params]
    return out


def _module_ctypes(tree: ast.Module) -> dict[str, str]:
    """Module-level names bound to ctypes types -> their kinds
    (``_P, _I = ctypes.c_void_p, ctypes.c_int``)."""
    out = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for t in stmt.targets:
            pairs = (zip(t.elts, stmt.value.elts)
                     if isinstance(t, ast.Tuple)
                     and isinstance(stmt.value, ast.Tuple)
                     and len(t.elts) == len(stmt.value.elts)
                     else [(t, stmt.value)])
            for name, value in pairs:
                kind = _CTYPES_KIND.get((au.dotted(value) or "")
                                        .split(".")[-1])
                if isinstance(name, ast.Name) and kind:
                    out[name.id] = kind
    return out


def _signatures(tree: ast.Module) -> Optional[ast.Dict]:
    for stmt in tree.body:
        target = (stmt.targets[0] if isinstance(stmt, ast.Assign)
                  and len(stmt.targets) == 1 else
                  stmt.target if isinstance(stmt, ast.AnnAssign) else None)
        if isinstance(target, ast.Name) and target.id == "SIGNATURES" \
                and isinstance(stmt.value, ast.Dict):
            return stmt.value
    return None


@rule("KER203", "launch-signature",
      "a build.SIGNATURES entry differs from its extern \"C\" prototype in "
      "kernels/csrc/<library>.cu (count or parameter kinds)",
      hint="make the argtypes list the prototype's parameters in order: "
           "c_void_p for each pointer and the stream, c_int for an int, "
           "c_float for a float — ctypes passes what the list says, and a "
           "mismatch shifts every later argument")
def check_launch_signature(ctx) -> Iterable[Finding]:
    """PAL203's counterpart.  Reads the module-level ``SIGNATURES`` dict
    (library -> {C function: argtypes}) of a module and the CUDA sources in
    ``csrc/`` beside it."""
    sigs = _signatures(ctx.tree)
    if sigs is None:
        return
    kinds = _module_ctypes(ctx.tree)
    csrc = Path(ctx.path).resolve().parent / "csrc"

    def finding(node, msg):
        return Finding(rule="KER203", path=ctx.path, line=node.lineno,
                       col=node.col_offset, end_line=node.lineno,
                       message=msg)

    for lib_key, entry in zip(sigs.keys, sigs.values):
        lib = lib_key.value if isinstance(lib_key, ast.Constant) else None
        if not isinstance(lib, str) or not isinstance(entry, ast.Dict):
            continue
        src = csrc / f"{lib}.cu"
        if not src.is_file():
            yield finding(lib_key, f"library `{lib}` has no source {src}")
            continue
        protos = _prototypes(src.read_text(encoding="utf-8"))
        for fn_key, args in zip(entry.keys, entry.values):
            fn = fn_key.value if isinstance(fn_key, ast.Constant) else None
            if not isinstance(fn, str) or not isinstance(args, ast.List):
                continue
            if fn not in protos:
                yield finding(fn_key, f"`{fn}` has no extern \"C\" "
                                      f"definition in {src.name}")
                continue
            want = protos[fn]
            got = [kinds.get(a.id, "unknown") if isinstance(a, ast.Name)
                   else _CTYPES_KIND.get((au.dotted(a) or "")
                                         .split(".")[-1], "unknown")
                   for a in args.elts]
            if len(got) != len(want):
                yield finding(fn_key, f"`{fn}`: {len(got)} argtypes, but "
                                      f"{src.name} declares {len(want)} "
                                      f"parameters")
                continue
            for i, (g, (w, text)) in enumerate(zip(got, want)):
                if g != w and not (g == "pointer" and w == "stream"):
                    yield finding(fn_key, f"`{fn}`: argtype {i} is {g}, "
                                          f"but parameter {i} of "
                                          f"{src.name} is `{text}` ({w})")
                    break


# ---------------------------------------------------------------------------
# KER206 — launches whose outputs bypass autograd
# ---------------------------------------------------------------------------

def _launches_directly(fn: ast.FunctionDef) -> bool:
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Attribute) and f.attr.endswith("_launch"):
            return True              # lib.<name>_launch(...)
        if isinstance(f, ast.Name) and f.id.startswith("_launch"):
            return True              # _launch_forward(...)
    return False


def _grad_functions(tree: ast.Module) -> set:
    """Classes of the module that subclass ``autograd.Function``."""
    return {name for name, bases in au.class_bases(tree).items()
            if any(b == "Function" or b.endswith("autograd.Function")
                   for b in bases)}


def _routes_grad(fn: ast.FunctionDef, grad_fns: set) -> bool:
    """``refuse_grad(...)`` anywhere, or an ``if`` on ``needs_grad(...)``
    (or a name assigned from it) whose body calls ``<Function>.apply``."""
    flags = set()
    for stmt in au.own_statements(fn.body):
        for node in au.stmt_exprs(stmt):
            if isinstance(node, ast.Call) \
                    and au.callee_is(node, "refuse_grad"):
                return True
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call) \
                and au.callee_is(stmt.value, "needs_grad"):
            flags |= {n for t in stmt.targets for n in au.target_names(t)}
    for stmt in au.own_statements(fn.body):
        if not isinstance(stmt, ast.If):
            continue
        tests_grad = any(
            (isinstance(n, ast.Call) and au.callee_is(n, "needs_grad"))
            or (isinstance(n, ast.Name) and n.id in flags)
            for n in ast.walk(stmt.test))
        applies = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "apply"
            and (au.dotted(n.func.value) or "").split(".")[-1] in grad_fns
            for s in stmt.body for n in ast.walk(s))
        if tests_grad and applies:
            return True
    return False


def _returns_value(fn: ast.FunctionDef) -> bool:
    return any(isinstance(s, ast.Return) and s.value is not None
               and not (isinstance(s.value, ast.Constant)
                        and s.value.value is None)
               for s in au.own_statements(fn.body))


@rule("KER206", "grad-bypass",
      "a kernel wrapper returns a ctypes launch's outputs with no autograd "
      "route (neither build.refuse_grad nor needs_grad -> "
      "autograd.Function.apply)",
      hint="route `if build.needs_grad(...)` to an autograd.Function whose "
           "backward is a kernel too, or call build.refuse_grad(...) where "
           "nothing differentiates the kernel; a ctypes-filled output has "
           "no grad_fn, so its gradient is silently dropped")
def check_grad_bypass(ctx) -> Iterable[Finding]:
    """The rule behind the port's silent frozen-attention fault, when a
    wrapper's CUDA route returned the forward kernel's output under
    autograd and the attention weights never trained.  Applies to the
    module-level functions of ``kernels/*.py`` that launch a kernel (a
    ``lib.*_launch`` call, a ``_launch*`` helper, or a function of the
    module that does either) and return a value; the ``_launch*`` helpers
    themselves and the autograd Functions' methods are what a wrapper
    routes to, and are exempt."""
    if not ctx.under("kernels", "*"):
        return
    fns = {s.name: s for s in ctx.tree.body
           if isinstance(s, au.FUNCTION_TYPES)}
    launching = {n for n, f in fns.items() if _launches_directly(f)}
    grown = True
    while grown:                     # functions reaching a launcher
        grown = False
        for name, f in fns.items():
            if name in launching:
                continue
            if any(isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                   and c.func.id in launching for c in ast.walk(f)):
                launching.add(name)
                grown = True
    grad_fns = _grad_functions(ctx.tree)
    for name in sorted(launching, key=lambda n: fns[n].lineno):
        fn = fns[name]
        if name.startswith("_launch") or not _returns_value(fn) \
                or _routes_grad(fn, grad_fns):
            continue
        yield Finding(
            rule="KER206", path=ctx.path, line=fn.lineno,
            col=fn.col_offset, end_line=fn.lineno,
            message=f"`{name}` returns a kernel launch's outputs with no "
                    f"autograd route: under autograd they carry no "
                    f"grad_fn and the gradient is silently dropped")
