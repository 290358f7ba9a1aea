"""dy2static: the AST rewrite of native Python control flow (port of
paddle_tpu/jit/dy2static.py).

``if`` / ``while`` / ``for`` over tensors become the dual-regime
control-flow APIs (``paddle_tpu_torch.static.nn.cond`` / ``while_loop``),
which run as plain Python when the predicate is concrete and as
``torch.cond`` / the ``while_loop`` higher-order op under a capture
(``torch.export``, as ``jit.to_static`` runs it), so one rewritten
function serves eager and captured calls.

Scope (the reference's; everything outside it is left untouched and keeps
exact Python semantics):
- `if`/`elif`/`else` whose bodies contain no return/break/continue/
  yield/del, no attribute/subscript stores, and assign at least one
  local name.  Variables assigned under the `if` must already exist
  before it (the reference raises the same ``NameError`` under capture).
- `while` with the same body restrictions (no `else:` clause).
- `for <name> in range(...)` — lowered to a `while` first.
Functions whose source is unavailable, or where the transform fails for
any reason, fall back to the original function unchanged, as in the
reference: that is its semantics, not a device fallback.
"""
from __future__ import annotations

import ast
import builtins
import functools
import inspect
import textwrap
from collections import Counter
from typing import Callable, List, Sequence, Set

__all__ = ["convert_to_static", "run_if", "run_while", "loop_cont",
           "range3"]

_GEN_PREFIX = "__pt_"


# ---------------------------------------------------------------------------
# runtime helpers (referenced by generated code as _jst.*)
# ---------------------------------------------------------------------------


class _Undefined:
    """Placeholder for a name not yet bound when a converted statement
    runs (the reference's UndefinedVar, dygraph_to_static/utils.py)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"


UNDEF = _Undefined()


def grab(loc: dict, names):
    """Fetch current locals by name; missing names become UNDEF (they may
    be written by the converted statement itself)."""
    return tuple(loc.get(n, UNDEF) for n in names)


def _is_traced(x):
    from paddle_tpu_torch.static.nn import _is_traced as traced
    return traced(x)


def run_if(pred, true_fn, false_fn, operands, params, need_init):
    """Dual-regime if: python branch for concrete preds, ``torch.cond``
    under a capture (via static.nn.cond).  ``need_init`` = names written in only
    one branch: under a trace their incoming value IS the other branch's
    result, so they must exist before the statement."""
    from paddle_tpu_torch.static.nn import cond
    if _is_traced(pred):
        for n in need_init:
            if operands[params.index(n)] is UNDEF:
                raise NameError(
                    f"dy2static: variable {n!r} is assigned in only one "
                    f"branch of a tensor-dependent `if` and does not exist "
                    f"before it — initialize it first (the reference's "
                    f"dy2static imposes the same constraint)")
    out = cond(pred, lambda: tuple(true_fn(*operands)),
               lambda: tuple(false_fn(*operands)))
    return tuple(out)


def run_while(test_fn, body_fn, loop_vars, params):
    from paddle_tpu_torch.static.nn import while_loop
    loop_vars = tuple(loop_vars)
    t = test_fn(*loop_vars)
    if not _is_traced(t) and not any(_is_traced(v) for v in loop_vars):
        while bool(t):
            loop_vars = tuple(body_fn(*loop_vars))
            t = test_fn(*loop_vars)
        return loop_vars
    for n, v in zip(params, loop_vars):
        if v is UNDEF:
            raise NameError(
                f"dy2static: variable {n!r} is used by a tensor-bounded "
                f"`while`/`for` but does not exist before the loop — "
                f"initialize it first")
    out = while_loop(lambda *vs: test_fn(*vs),
                     lambda *vs: tuple(body_fn(*vs)), loop_vars)
    return tuple(out)


def loop_cont(i, stop, step):
    """Sign-aware range continuation predicate (tensor- or int-valued).
    Branchless on the tensor path — ``step`` may itself be a loop carry
    and hence traced."""
    if isinstance(step, (int, float)):
        return (i < stop) if step > 0 else (i > stop)
    return ((step > 0) & (i < stop)) | ((step <= 0) & (i > stop))


def prebind(loc: dict, name: str, start):
    """Loop-target pre-bind that must not clobber a pre-existing value
    (an empty range never rebinds its target in Python)."""
    return loc.get(name, start)


def range3(*args):
    if len(args) == 1:
        return 0, args[0], 1
    if len(args) == 2:
        return args[0], args[1], 1
    return args[0], args[1], args[2]


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


class _NameCollector(ast.NodeVisitor):
    """Reads/writes of local names in a statement list, NOT descending
    into nested function/class scopes."""

    def __init__(self):
        self.reads: Set[str] = set()
        self.writes: Set[str] = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            self.writes.add(node.id)
        elif isinstance(node.ctx, ast.Load):
            self.reads.add(node.id)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self.writes.add(node.name)      # binding only; don't enter scope

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.writes.add(node.name)

    def visit_Lambda(self, node):
        for d in node.args.defaults + node.args.kw_defaults:
            if d is not None:
                self.visit(d)


_FN_PREFIXES = tuple(_GEN_PREFIX + k for k in
                     ("true_", "false_", "test_", "body_"))


def _is_gen_fn(name: str) -> bool:
    return name.startswith(_FN_PREFIXES)


def _names(nodes: Sequence[ast.AST]):
    c = _NameCollector()
    for n in nodes:
        c.visit(n)
    # generated branch/body function names bind locally next to their use
    # and must not become region parameters; generated VALUE names
    # (__pt_i_N etc.) are ordinary locals and stay
    c.reads -= {n for n in c.reads if _is_gen_fn(n)}
    c.writes -= {n for n in c.writes if _is_gen_fn(n)}
    return c.reads, c.writes


def _incoming_reads(nodes: Sequence[ast.AST]) -> Set[str]:
    """Names read before any write in statement order — the values a
    converted region needs from the enclosing scope (approximate: within
    one statement reads are assumed to precede writes, which holds for
    `x = f(x)` and everything the transformer emits)."""
    incoming: Set[str] = set()
    written: Set[str] = set()
    for stmt in nodes:
        r, w = _names([stmt])
        incoming |= r - written
        written |= w
    return incoming


class _LoadCounter(ast.NodeVisitor):
    """Name-Load site counts, descending into every scope (a nested
    lambda/def closing over a local still reads it)."""

    def __init__(self):
        self.counts: Counter = Counter()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.counts[node.id] += 1
        self.generic_visit(node)


def _count_loads(nodes) -> Counter:
    c = _LoadCounter()
    for n in (nodes if isinstance(nodes, (list, tuple)) else [nodes]):
        c.visit(n)
    return c.counts


class _EscapeScanner(ast.NodeVisitor):
    """True if the statements can't be outlined into a branch function:
    control-flow escapes, scope statements, or non-name stores."""

    def __init__(self):
        self.escapes = False

    def _mark(self, *_):
        self.escapes = True

    visit_Return = visit_Break = visit_Continue = _mark
    visit_Yield = visit_YieldFrom = visit_Await = _mark
    visit_Global = visit_Nonlocal = visit_Delete = _mark
    # a walrus inside an outlined expression would assign into the
    # throwaway function's scope and be lost (confirmed: a walrus in a
    # while-test makes the converted loop spin forever) — leave such
    # statements untouched
    visit_NamedExpr = _mark

    def visit_Attribute(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.escapes = True
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.escapes = True
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        pass                             # nested scope: escapes stay local

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef


def _escapes(nodes: Sequence[ast.AST]) -> bool:
    s = _EscapeScanner()
    for n in nodes:
        s.visit(n)
    return s.escapes


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def _arglist(names: List[str]) -> ast.arguments:
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
        defaults=[])


def _name_tuple(names: List[str], ctx) -> ast.AST:
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names],
                     ctx=ctx())


def _jst_call(fn: str, args: List[ast.AST]) -> ast.Call:
    return ast.Call(
        func=ast.Attribute(value=ast.Name(id="_jst", ctx=ast.Load()),
                           attr=fn, ctx=ast.Load()),
        args=args, keywords=[])


class _Transformer(ast.NodeTransformer):
    def __init__(self, global_names: Set[str],
                 local_names: Set[str] = frozenset(),
                 fn_loads: Counter = None):
        self.skip = (set(global_names) | set(dir(builtins)) | {"_jst"}) \
            - set(local_names)
        self.count = 0
        self.changed = False
        # Load-site counts over the WHOLE original function: a name whose
        # every load lies inside one converted region is invisible outside
        # it and can stay local to the generated body/branch functions.
        self.fn_loads = fn_loads if fn_loads is not None else Counter()

    def _grab(self, params: List[str]) -> ast.Call:
        return _jst_call("grab", [
            ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                     args=[], keywords=[]),
            ast.List(elts=[ast.Constant(value=n) for n in params],
                     ctx=ast.Load())])

    @staticmethod
    def _strlist(names: List[str]) -> ast.List:
        return ast.List(elts=[ast.Constant(value=n) for n in names],
                        ctx=ast.Load())

    def _region_locals(self, node, writes, incoming):
        """Names written in the region, never read before the write inside
        it, and whose every Load site in the function lies inside the
        region — pure temporaries that stay local to the generated
        functions instead of becoming carries/outputs."""
        sub = _count_loads(node)
        return {w for w in writes
                if w not in incoming and self.fn_loads[w] == sub[w]}

    # -- if ---------------------------------------------------------------
    def visit_If(self, node: ast.If):
        body, orelse = node.body, node.orelse or []
        if _escapes(body) or _escapes(orelse):
            self.generic_visit(node)
            return node
        # analyze the ORIGINAL region before children are rewritten —
        # converted children read their operands through grab(locals()),
        # which static analysis cannot see
        _, w_body = _names(body)
        _, w_else = _names(orelse)
        writes = (w_body | w_else) - self.skip
        incoming = (_incoming_reads(body) | _incoming_reads(orelse)) \
            - self.skip
        local_tmp = self._region_locals(node, writes, incoming)
        writes -= local_tmp
        if not writes:
            self.generic_visit(node)
            return node
        self.generic_visit(node)
        body, orelse = node.body, node.orelse or []
        params = sorted(incoming | writes)
        outs = sorted(writes)
        # written in only one branch → the other returns the incoming
        # value, which must therefore exist (runtime-checked under trace)
        need_init = sorted(((w_body ^ w_else) - self.skip) - local_tmp)
        self.changed = True
        i = self.count = self.count + 1
        ret = ast.Return(value=_name_tuple(outs, ast.Load))
        tdef = ast.FunctionDef(
            name=f"{_GEN_PREFIX}true_{i}", args=_arglist(params),
            body=list(body) + [ret], decorator_list=[])
        fdef = ast.FunctionDef(
            name=f"{_GEN_PREFIX}false_{i}", args=_arglist(params),
            body=(list(orelse) if orelse else [ast.Pass()]) + [ret],
            decorator_list=[])
        assign = ast.Assign(
            targets=[_name_tuple(outs, ast.Store)],
            value=_jst_call("run_if", [
                node.test,
                ast.Name(id=tdef.name, ctx=ast.Load()),
                ast.Name(id=fdef.name, ctx=ast.Load()),
                self._grab(params),
                self._strlist(params),
                self._strlist(need_init)]))
        return [tdef, fdef, assign]

    # -- while ------------------------------------------------------------
    def visit_While(self, node: ast.While):
        if node.orelse or _escapes(node.body) or _escapes([node.test]):
            self.generic_visit(node)
            return node
        # original-region analysis (see visit_If); the loop carry is what
        # the test reads plus what the body reads before writing, plus
        # writes someone outside the loop can observe — a temp written
        # before every read and loaded nowhere else stays body-local
        test_reads, _ = _names([node.test])
        _, writes = _names(node.body)
        writes -= self.skip
        required = (test_reads | _incoming_reads(node.body)) - self.skip
        local_tmp = self._region_locals(node, writes, required)
        if not (writes - local_tmp):
            self.generic_visit(node)
            return node
        self.generic_visit(node)
        loc = sorted(required | (writes - local_tmp))
        self.changed = True
        i = self.count = self.count + 1
        tdef = ast.FunctionDef(
            name=f"{_GEN_PREFIX}test_{i}", args=_arglist(loc),
            body=[ast.Return(value=node.test)], decorator_list=[])
        bdef = ast.FunctionDef(
            name=f"{_GEN_PREFIX}body_{i}", args=_arglist(loc),
            body=list(node.body) + [
                ast.Return(value=_name_tuple(loc, ast.Load))],
            decorator_list=[])
        assign = ast.Assign(
            targets=[_name_tuple(loc, ast.Store)],
            value=_jst_call("run_while", [
                ast.Name(id=tdef.name, ctx=ast.Load()),
                ast.Name(id=bdef.name, ctx=ast.Load()),
                self._grab(loc),
                self._strlist(loc)]))
        return [tdef, bdef, assign]

    # -- for over range ---------------------------------------------------
    def visit_For(self, node: ast.For):
        if not (isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and not node.iter.keywords
                and not node.orelse
                and not _escapes(node.body)):
            self.generic_visit(node)
            return node
        i = self.count = self.count + 1
        iv = f"{_GEN_PREFIX}i_{i}"
        start, stop, step = (f"{_GEN_PREFIX}start_{i}",
                             f"{_GEN_PREFIX}stop_{i}",
                             f"{_GEN_PREFIX}step_{i}")
        setup = ast.Assign(
            targets=[ast.Tuple(elts=[
                ast.Name(id=n, ctx=ast.Store())
                for n in (start, stop, step)], ctx=ast.Store())],
            value=_jst_call("range3", list(node.iter.args)))
        init = ast.Assign(targets=[ast.Name(id=iv, ctx=ast.Store())],
                          value=ast.Name(id=start, ctx=ast.Load()))
        # pre-bind the loop target so it is a valid while_loop carry even
        # when it did not exist before the loop — via prebind() so an
        # empty range does not clobber a pre-existing value
        bind0 = ast.Assign(
            targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
            value=_jst_call("prebind", [
                ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                         args=[], keywords=[]),
                ast.Constant(value=node.target.id),
                ast.Name(id=start, ctx=ast.Load())]))
        test = _jst_call("loop_cont", [
            ast.Name(id=iv, ctx=ast.Load()),
            ast.Name(id=stop, ctx=ast.Load()),
            ast.Name(id=step, ctx=ast.Load())])
        bind = ast.Assign(targets=[ast.Name(id=node.target.id,
                                            ctx=ast.Store())],
                          value=ast.Name(id=iv, ctx=ast.Load()))
        incr = ast.Assign(
            targets=[ast.Name(id=iv, ctx=ast.Store())],
            value=ast.BinOp(left=ast.Name(id=iv, ctx=ast.Load()),
                            op=ast.Add(),
                            right=ast.Name(id=step, ctx=ast.Load())))
        loop = ast.While(test=test, body=[bind] + list(node.body) + [incr],
                         orelse=[])
        out = self.visit_While(loop)
        if out is loop:                 # while transform declined
            self.generic_visit(node)
            return node
        return [setup, init, bind0] + list(out)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def convert_to_static(fn: Callable) -> Callable:
    """AST-convert ``fn``; returns ``fn`` unchanged when nothing applies
    or the source is unavailable (C functions, lambdas, REPL input)."""
    inner = fn.__func__ if inspect.ismethod(fn) else fn
    if getattr(inner, "_pt_dy2static", False) or \
            getattr(inner, "_not_to_static", False):
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(inner))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return fn
        fdef.decorator_list = []
        # closure freevars are injected into the exec globals below, so
        # they are non-local from the transformed function's perspective;
        # locals that SHADOW a global/builtin (e.g. `input`) are still
        # locals — co_varnames wins over the whole skip set
        tr = _Transformer(
            set(inner.__globals__) | set(inner.__code__.co_freevars),
            local_names=set(inner.__code__.co_varnames),
            fn_loads=_count_loads(fdef))
        tree = tr.visit(tree)
        if not tr.changed:
            return fn
        # the rewritten function is made inside an outer one whose
        # arguments are ``_jst`` and the closure's values (frozen at
        # conversion time, as the reference freezes them): closures, not
        # globals, so that a capture's tracer finds them where it looks
        import paddle_tpu_torch.jit.dy2static as _self
        free = list(inner.__code__.co_freevars)
        values = [_self]
        for cell in inner.__closure__ or ():
            try:
                values.append(cell.cell_contents)
            except ValueError:
                return fn
        fdef = tree.body[0]
        outer = ast.FunctionDef(
            name=f"{_GEN_PREFIX}outer", args=_arglist(["_jst"] + free),
            body=[fdef, ast.Return(value=ast.Name(id=fdef.name,
                                                  ctx=ast.Load()))],
            decorator_list=[])
        tree.body = [outer]
        ast.fix_missing_locations(tree)
        code = compile(tree, f"<dy2static:{inner.__name__}>", "exec")
        ns: dict = {}
        exec(code, inner.__globals__, ns)
        new_fn = ns[outer.name](*values)
        new_fn._pt_dy2static = True
        new_fn = functools.wraps(inner)(new_fn)
        if inspect.ismethod(fn):
            return new_fn.__get__(fn.__self__)
        return new_fn
    except Exception:
        return fn
