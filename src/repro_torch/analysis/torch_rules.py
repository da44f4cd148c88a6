"""Eager-CUDA rules (CUDA1xx): the JIT rules' counterparts for PyTorch.

The reference's JIT1xx rules guard its jitted programs: no Python branch on
a tracer, one B-int32 sync a tick, no retrace in a loop, no re-upload of
loop-invariant host data.  The port runs eagerly on CUDA, where the same
hazards take other shapes:

* CUDA101 — a Python branch on the RANK whose branches issue different
  collectives: ranks that take different branches wait for each other
  forever (JIT101's counterpart: control flow that differs where it must
  not);
* CUDA102 — a host sync in the serving tick's modules: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int``/``float``/``bool`` or
  ``np.asarray`` of a tensor, ``torch.cuda.synchronize()`` (JIT102's);
* CUDA103 — a kernel library, ``torch.compile``, a CUDA graph or a stage
  program built inside a loop without a cache (JIT103's);
* CUDA105 — ``.to(device)``, ``.cuda()`` or ``torch.tensor(...,
  device=...)`` of loop-invariant host data inside a loop (JIT105's).

JIT104 (a buffer read after it was donated) has no counterpart: the port
writes its caches in place and donates nothing.  Everything here is
syntactic, as the reference's rules: a tensor is recognised by where it
came from in the function (a ``torch.*`` call, a tensor's method, an
expression of tensors), never by running the code.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis import astutil as au
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

# ---------------------------------------------------------------------------
# CUDA101 — a branch on the rank around collectives
# ---------------------------------------------------------------------------

RANK_CALLS = ("comm.axis_index", "dist.get_rank", "distributed.get_rank")
RANK_NAMES = {"rank"}
# parallel/comm.py's collectives, and torch.distributed's
COMM_OPS = {"psum", "pmax", "ppermute", "all_gather", "psum_scatter",
            "gather_leaf"}
DIST_OPS = {"all_reduce", "all_gather", "all_gather_into_tensor",
            "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
            "all_to_all", "all_to_all_single", "broadcast",
            "broadcast_object_list", "reduce", "gather", "scatter",
            "barrier", "monitored_barrier", "send", "recv", "isend",
            "irecv", "batch_isend_irecv"}


def _collective(call: ast.Call) -> Optional[str]:
    c = au.callee(call) or ""
    parts = c.split(".")
    if len(parts) >= 2 and parts[-2] == "comm" and parts[-1] in COMM_OPS:
        return c
    if parts[0] in ("dist", "torch") and parts[-1] in DIST_OPS \
            and (parts[0] == "dist" or parts[1:2] == ["distributed"]):
        return c
    return None


def _collectives(nodes, fns: dict, hop: bool = True) -> list[str]:
    """The collectives the code in ``nodes`` issues: its own calls, and one
    hop into functions of the same module it calls by name."""
    out = []
    for top in nodes:
        for sub in ast.walk(top):
            if not isinstance(sub, ast.Call):
                continue
            if (op := _collective(sub)) is not None:
                out.append(op)
            elif hop and isinstance(sub.func, ast.Name) \
                    and sub.func.id in fns:
                out += _collectives(fns[sub.func.id].body, fns, hop=False)
    return sorted(out)


def _reads_rank(expr: ast.AST, ranky: set) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and au.callee_is(sub, *RANK_CALLS):
            return True
        if isinstance(sub, ast.Name) and (sub.id in ranky
                                          or sub.id in RANK_NAMES):
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in RANK_NAMES:
            return True
    return False


def _child_defs(body: list):
    """Function defs of this scope's statement tree (methods of classes
    defined here too), not those nested in them."""
    for stmt in body:
        if isinstance(stmt, au.FUNCTION_TYPES):
            yield stmt
        elif isinstance(stmt, ast.ClassDef):
            yield from _child_defs(stmt.body)
        else:
            for attr in ("body", "orelse", "finalbody"):
                yield from _child_defs(getattr(stmt, attr, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                yield from _child_defs(h.body)


@rule("CUDA101", "rank-branch",
      "an if/while/conditional expression on the rank whose branches issue "
      "different collectives",
      hint="select the value with comm.where(cond, a, b) "
           "(parallel/comm.py): both branches run on every rank, so every "
           "rank issues the same collectives in the same order")
def check_rank_branch(ctx) -> Iterable[Finding]:
    """JIT101's counterpart.  A rank is read through ``comm.axis_index``,
    ``dist.get_rank`` or a name or attribute called ``rank``, directly or
    through a name assigned from one (in the function or an enclosing
    one).  Ranks that take different branches of such a test and issue
    different collectives there (their own calls, and those of module
    functions they call) wait on each other forever."""
    fns = ctx.functions
    seen = set()

    def unequal(node, a, b, what):
        ops_a, ops_b = _collectives(a, fns), _collectives(b, fns)
        if ops_a == ops_b or node.lineno in seen:
            return None
        seen.add(node.lineno)
        return Finding(
            rule="CUDA101", path=ctx.path, line=node.lineno,
            col=node.col_offset, end_line=node.lineno,
            message=f"`{what}` on the rank reaches collectives unequally "
                    f"({', '.join(ops_a) or 'none'} against "
                    f"{', '.join(ops_b) or 'none'}): ranks taking "
                    f"different branches deadlock")

    def visit(body: list, inherited: set):
        ranky = set(inherited)
        for stmt in au.own_statements(body):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                    and stmt.value is not None:
                names = {n for t in au.assign_targets(stmt)
                         if isinstance(t, (ast.Name, ast.Tuple, ast.List))
                         for n in au.target_names(t)}
                if _reads_rank(stmt.value, ranky):
                    ranky |= names
                else:
                    ranky -= names
            if isinstance(stmt, (ast.If, ast.While)) \
                    and _reads_rank(stmt.test, ranky):
                f = unequal(stmt, stmt.body,
                            stmt.orelse if isinstance(stmt, ast.If) else [],
                            "if" if isinstance(stmt, ast.If) else "while")
                if f is not None:
                    yield f
            for node in au.stmt_exprs(stmt):
                if isinstance(node, ast.IfExp) \
                        and _reads_rank(node.test, ranky):
                    f = unequal(node, [node.body], [node.orelse],
                                "... if ... else ...")
                    if f is not None:
                        yield f
        for fn in _child_defs(body):
            yield from visit(fn.body, ranky)

    yield from visit(ctx.tree.body, set())


# ---------------------------------------------------------------------------
# CUDA102 — host syncs in the tick's modules
# ---------------------------------------------------------------------------

# the modules the serving tick runs: a sync there stalls every tick
TICK_MODULES = (("serving", "engine.py"), ("serving", "executor_cache.py"),
                ("models", "*"))
_HOST_CALLS = {"torch.is_tensor", "torch.device", "torch.finfo",
               "torch.iinfo", "torch.Size", "torch.get_default_dtype",
               "torch.is_grad_enabled", "torch.Generator", "torch.no_grad",
               "torch.enable_grad", "torch.inference_mode"}
# tensor methods and attributes whose result lives on the host already
_HOST_METHODS = {"cpu", "numpy", "tolist", "item", "size", "dim", "numel",
                 "data_ptr", "is_contiguous", "element_size", "stride",
                 "get_device", "nelement", "is_floating_point"}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "grad_fn"}
_SYNC_BUILTINS = {"float", "int", "bool"}
_SYNC_ARRAYS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}


def _tensorish(node: ast.AST, tensors: set) -> bool:
    """Whether ``node`` evaluates to a tensor, by its provenance."""
    if isinstance(node, ast.Call):
        c = au.callee(node) or ""
        if c.startswith(("torch.", "F.")) and not c.startswith(
                "torch.cuda.") and c not in _HOST_CALLS:
            return True
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr not in _HOST_METHODS:
            return _tensorish(node.func.value, tensors)
        return False
    if isinstance(node, ast.Subscript):
        return _tensorish(node.value, tensors)
    if isinstance(node, ast.Attribute):
        return node.attr not in _HOST_ATTRS \
            and _tensorish(node.value, tensors)
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.BinOp):
        return _tensorish(node.left, tensors) \
            or _tensorish(node.right, tensors)
    if isinstance(node, ast.UnaryOp):
        return _tensorish(node.operand, tensors)
    return False


def _sync_hit(node: ast.Call, tensors: set) -> Optional[str]:
    c = au.callee(node) or ""
    if au.callee_is(node, "torch.cuda.synchronize"):
        return "torch.cuda.synchronize()"
    if c in _SYNC_ARRAYS and node.args and _tensorish(node.args[0], tensors):
        return c
    if c in _SYNC_BUILTINS and len(node.args) == 1 \
            and _tensorish(node.args[0], tensors):
        return f"{c}()"
    if isinstance(node.func, ast.Attribute):
        attr, base = node.func.attr, node.func.value
        if attr == "cpu" and not node.args:
            return ".cpu()"
        if attr in ("item", "tolist", "numpy") and _tensorish(base, tensors):
            return f".{attr}()"
        if attr == "to" and any(isinstance(a, ast.Constant)
                                and a.value == "cpu" for a in
                                [*node.args, *(k.value for k in
                                               node.keywords)]):
            return '.to("cpu")'
    return None


@rule("CUDA102", "host-sync",
      "a device->host sync (.item / .tolist / .cpu / .numpy / int / float "
      "/ bool / np.asarray of a tensor, torch.cuda.synchronize) in the "
      "serving tick's modules",
      hint="the tick's contract is ONE sync, its B int32 token ids: keep "
           "values on the device or batch the transfer; suppress with a "
           "justification where this sync is the intended one or the path "
           "is not the tick")
def check_host_sync(ctx) -> Iterable[Finding]:
    """JIT102's counterpart, in ``serving/engine.py``,
    ``serving/executor_cache.py`` and ``models/*.py``: each such call
    waits for the device to drain the queue before the host goes on."""
    if not any(ctx.under(*m) for m in TICK_MODULES):
        return
    for fn in au.iter_functions(ctx.tree):
        tensors: set = set()
        for stmt in au.own_statements(fn.body):
            for node in au.stmt_exprs(stmt):
                if isinstance(node, ast.Call) \
                        and (hit := _sync_hit(node, tensors)) is not None:
                    yield Finding(
                        rule="CUDA102", path=ctx.path, line=node.lineno,
                        col=node.col_offset, end_line=node.end_lineno,
                        message=f"`{hit}` forces a device->host sync in "
                                f"`{fn.name}`")
            if isinstance(stmt, ast.Assign):
                names = {n for t in stmt.targets
                         for n in au.target_names(t)
                         if isinstance(t, (ast.Name, ast.Tuple, ast.List))}
                if _tensorish(stmt.value, tensors):
                    tensors |= names
                else:
                    tensors -= names


# ---------------------------------------------------------------------------
# CUDA103 — builds inside a loop
# ---------------------------------------------------------------------------

_BUILDS = ("build.library", "build.load_all", "torch.compile",
           "torch.cuda.CUDAGraph", "torch.cuda.graph")


def _is_build(node: ast.Call) -> bool:
    if au.callee_is(node, *_BUILDS):
        return True
    tail = (au.callee(node) or "").split(".")[-1]
    # a stage program (serving/executor_cache.py: *Program classes)
    return tail.endswith("Program") and tail[:1].isupper()


@rule("CUDA103", "build-in-loop",
      "a kernel library, torch.compile, a CUDA graph or a stage program "
      "built inside a loop without a cache",
      hint="build it once above the loop, or through a keyed cache (the "
           "executor cache, functools.lru_cache): each iteration pays the "
           "build again")
def check_build_in_loop(ctx) -> Iterable[Finding]:
    """JIT103's counterpart.  A construction inside a lambda or def in the
    loop (a cache's maker) is not in the loop's scope, and a def decorated
    with a cache builds once per key."""
    parents = ctx.parents
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and _is_build(node)):
            continue
        loop = au.loop_in_scope(node, parents)
        if loop is None or au.is_cached(au.scope_of(node, parents)):
            continue
        yield Finding(
            rule="CUDA103", path=ctx.path, line=node.lineno,
            col=node.col_offset, end_line=node.end_lineno,
            message=f"`{au.callee(node)}` is built inside a "
                    f"`{type(loop).__name__.lower()}` loop: every iteration "
                    f"builds it again")


# ---------------------------------------------------------------------------
# CUDA105 — loop-invariant host->device transfers inside a loop
# ---------------------------------------------------------------------------

def _device_like(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(node, ast.Call):
        return au.callee_is(node, "torch.device")
    name = au.dotted(node) or ""
    return "dev" in name.split(".")[-1].lower()


def _transfer_deps(call: ast.Call) -> Optional[set]:
    """The names a host->device transfer depends on, or None if ``call``
    is no transfer."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda":
        return au.names_read(f.value)
    if isinstance(f, ast.Attribute) and f.attr == "to":
        dev = au.kwarg(call, "device")
        if dev is None and not (call.args and _device_like(call.args[0])):
            return None
        return au.names_read(f.value)
    if au.callee_is(call, "torch.tensor", "torch.as_tensor") \
            and au.kwarg(call, "device") is not None and call.args:
        return au.names_read(call.args[0])
    return None


def _runs_once(node: ast.AST, loop: ast.AST, parents: dict) -> bool:
    """Whether ``node`` sits under an ``if x is None:`` (inside ``loop``)
    whose body binds ``x``: the lazy-init idiom, which runs once."""
    cur = parents.get(node)
    while cur is not None and cur is not loop:
        t = getattr(cur, "test", None)
        if isinstance(cur, ast.If) and isinstance(t, ast.Compare) \
                and len(t.ops) == 1 and isinstance(t.ops[0], ast.Is) \
                and isinstance(t.comparators[0], ast.Constant) \
                and t.comparators[0].value is None:
            name = next(au.target_names(t.left), None)
            bound = {n for s in cur.body for st in ast.walk(s)
                     if isinstance(st, ast.stmt)
                     for tg in au.assign_targets(st)
                     for n in au.target_names(tg)}
            if name in bound:
                return True
        cur = parents.get(cur)
    return False


@rule("CUDA105", "loop-invariant-transfer",
      "a host->device transfer of a loop-invariant value inside a loop",
      hint="upload it once above the loop: each iteration copies the same "
           "host data to the device again")
def check_loop_invariant_transfer(ctx) -> Iterable[Finding]:
    """JIT105's counterpart: ``.to(device)``, ``.cuda()`` or
    ``torch.tensor(..., device=...)`` whose source reads no name the
    enclosing loop (in the same scope) assigns, unless it runs once under
    an ``if x is None:`` that binds ``x``."""
    parents = ctx.parents
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        deps = _transfer_deps(node)
        if deps is None:
            continue
        loop = au.loop_in_scope(node, parents)
        if loop is None or deps & au.loop_assigned_names(loop) \
                or _runs_once(node, loop, parents):
            continue
        yield Finding(
            rule="CUDA105", path=ctx.path, line=node.lineno,
            col=node.col_offset, end_line=node.end_lineno,
            message=f"`{au.callee(node) or 'transfer'}` uploads "
                    f"loop-invariant host data on every iteration of the "
                    f"enclosing {type(loop).__name__.lower()} loop")
