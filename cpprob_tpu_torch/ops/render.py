"""The elementwise contract of user functions, and their rendering to CUDA
C++.

A model hands the port's generated kernels its physics and its densities
as plain Python functions over elementwise float32 values: a
``step_elem`` (K10, K11: :mod:`.user_chunk`) and a guided model's two
densities (K12 and its tensor-core twin: :mod:`.guided_scalar`,
:mod:`.guided_tc`).  The plain versions call the function on torch
tensors; the kernels compile its source.

**The contract.**  The function is a ``def`` (not a lambda) with
positional arguments only.  Its body is a sequence of assignments (to a
name, or a tuple of names from a tuple of values), augmented assignments
(``a += b``) and a final ``return`` of one value, or of a tuple of values
where the caller asks for one (a ``step_elem``).  Its expressions may use
``+ - * /``, ``a ** c`` for a number ``c`` (a constant or a captured
number), unary minus and plus, single comparisons (``a < b``), number
constants, local names and arguments, and the functions of
:mod:`cpprob_tpu_torch.ops.elem` (``exp``, ``log``, ``sqrt``, ``sin``,
``cos``, ``tanh``, ``where``, ``minimum``, ``maximum``), named through the
module (``elem.exp``) or imported from it.  It may capture numbers (int,
float, bool, numpy scalars), from its closure or its module, and number
attributes of modules (``math.pi``); each becomes a compile-time constant.
Nothing else: no tensors, no other functions, no ``if``, loops, ``**``
with an exponent that is not a number, chained comparisons or keyword
arguments.  A function outside the contract raises ``ValueError`` naming
the construct when the model is built (:func:`analyse_elem` checks the
names and captures, :func:`render_function` the rest).

**The rendering** (:func:`render_function`): ``+ - * /`` become the
round-to-nearest intrinsics ``__fadd_rn __fsub_rn __fmul_rn __fdiv_rn``
(so nvcc contracts no multiply-add and each operation rounds as torch's
float32 operation does), ``a ** c`` as torch's float32 ``pow`` rounds
it (``c`` = 2: ``a * a``; 3: ``a * a * a``; 0.5: ``__fsqrt_rn``; -1:
``__frcp_rn``; any other number CUDA's ``powf``), ``elem.sqrt``
``__fsqrt_rn``, ``exp log sin cos tanh`` CUDA's precise ``expf logf sinf
cosf tanhf``, ``where`` ``?:``,
``minimum``/``maximum`` ``fminf``/``fmaxf``; comparisons, unary minus,
locals and tuple unpacking as they stand; captured numbers float32
literals that convert back exactly.  A function returning a tuple becomes
a ``void`` function with one output reference per value.
"""

from __future__ import annotations

import ast
import inspect
import numbers
import textwrap
import types

import numpy as np

from . import elem as _elem

__all__ = ["analyse_elem", "analyse_step_elem", "render_function"]


# --------------------------------------------------------------------------
# the contract: source analysis


def _free_names(fn_node: ast.FunctionDef) -> set:
    args = {a.arg for a in fn_node.args.args}
    stored = {n.id for n in ast.walk(fn_node)
              if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
    loaded = {n.id for n in ast.walk(fn_node)
              if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    return loaded - args - stored


def _number(v):
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return None


class _Rewrite(ast.NodeTransformer):
    """Maps the elem namespace to ``_elem_*`` names, ``a / b`` to
    ``_div_rn(a, b)`` and module attributes that are numbers to constants;
    captured numbers become ``<prefix><name>`` constants."""

    def __init__(self, env: dict, consts: dict, fn: str, prefix: str):
        self.env, self.consts, self.fn, self.prefix = env, consts, fn, prefix

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id in self.env:
            mod = self.env[node.value.id]
            if mod is _elem:
                if node.attr not in _elem.NAMES:
                    raise ValueError(f"{self.fn}: elem.{node.attr} is not in "
                                     f"the namespace {_elem.NAMES}")
                return ast.copy_location(
                    ast.Name(id=f"_elem_{node.attr}", ctx=node.ctx), node)
            if isinstance(mod, types.ModuleType):
                val = _number(getattr(mod, node.attr, None))
                if val is not None:
                    return ast.copy_location(ast.Constant(val), node)
        raise ValueError(f"{self.fn}: attribute {ast.unparse(node)} is outside "
                         "the contract (elem functions and module numbers)")

    def visit_BinOp(self, node):
        # a / b rounds to nearest, as torch's division does
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Div):
            return ast.copy_location(ast.Call(
                func=ast.Name(id="_div_rn", ctx=ast.Load()),
                args=[node.left, node.right], keywords=[]), node)
        return node

    def visit_Name(self, node):
        if node.id in self.consts:
            return ast.copy_location(
                ast.Name(id=f"{self.prefix}{node.id}", ctx=node.ctx), node)
        v = self.env.get(node.id, node)
        if v is not node and callable(v):
            for name in _elem.NAMES:
                if v is getattr(_elem, name):
                    return ast.copy_location(
                        ast.Name(id=f"_elem_{name}", ctx=node.ctx), node)
        return node


def analyse_step_elem(step_elem, D: int, Dy: int = 1):
    """Check ``step_elem`` against the contract for D state planes and Dy
    observation planes.  Returns (the function's source rewritten, named
    ``step_elem``, and the captured constants {name: number}).  Raises
    ``ValueError`` on anything outside the contract."""
    ys = "y" if Dy == 1 else f"y_0..y_{Dy - 1}"
    return analyse_elem(step_elem, 2 * D + Dy, "step_elem",
                        f"x_0..x_{D - 1}, {ys}, eps_0..eps_{D - 1}")


def analyse_elem(fn, n_args: int, name: str, args: str, prefix: str = "_k_"):
    """Check an elementwise function against the contract of the module
    docstring, with ``n_args`` positional arguments (described by
    ``args``).  Returns (its source rewritten for the kernels, renamed
    ``name``, and the captured constants {name: number}, which the source
    reads as ``<prefix><name>``).  Raises ``ValueError`` on anything
    outside the contract."""
    if not isinstance(fn, types.FunctionType):
        raise ValueError(f"{name} must be a plain Python function")
    if fn.__name__ == "<lambda>":
        raise ValueError(f"{name} must be a def function, not a lambda: "
                         "the kernel is compiled from its source")
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise ValueError(f"{name} has no readable source: {e}") from None
    fn_node = next(n for n in ast.parse(src).body
                   if isinstance(n, ast.FunctionDef))
    if any(isinstance(n, (ast.Import, ast.ImportFrom, ast.Global,
                          ast.Nonlocal)) for n in ast.walk(fn_node)):
        raise ValueError(f"{name} may not import or declare globals: "
                         "import the elem namespace at module level")
    a = fn_node.args
    if (a.vararg or a.kwarg or a.kwonlyargs or a.defaults or a.posonlyargs
            or len(a.args) != n_args):
        raise ValueError(f"{name} must take {n_args} positional "
                         f"arguments ({args})")
    cv = inspect.getclosurevars(fn)
    env = {**cv.builtins, **cv.globals, **cv.nonlocals}
    consts = {}
    for free in sorted(_free_names(fn_node)):
        if free not in env:
            raise ValueError(f"{name}: unknown name {free!r}")
        v = env[free]
        num = _number(v)
        if num is not None:
            consts[free] = num
        elif v is _elem or any(v is getattr(_elem, f) for f in _elem.NAMES):
            continue
        elif isinstance(v, types.ModuleType):
            continue     # only its number attributes pass _Rewrite
        else:
            raise ValueError(
                f"{name}: {free!r} is a {type(v).__name__}; the kernel "
                "takes captured numbers and the elem namespace only")
    fn_node.decorator_list = []
    fn_node.name = name
    fn_node = _Rewrite(env, consts, name, prefix).visit(fn_node)
    ast.fix_missing_locations(fn_node)
    return ast.unparse(fn_node), consts


# --------------------------------------------------------------------------
# the rendering to C++


_FUNCS = {"_elem_exp": ("expf", 1), "_elem_log": ("logf", 1),
          "_elem_sqrt": ("__fsqrt_rn", 1), "_elem_sin": ("sinf", 1),
          "_elem_cos": ("cosf", 1), "_elem_tanh": ("tanhf", 1),
          "_elem_minimum": ("fminf", 2), "_elem_maximum": ("fmaxf", 2),
          "_div_rn": ("__fdiv_rn", 2)}
_BINOPS = {ast.Add: "__fadd_rn", ast.Sub: "__fsub_rn", ast.Mult: "__fmul_rn"}
_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
           ast.Eq: "==", ast.NotEq: "!="}


def _f32_literal(v) -> str:
    """A number as a C++ float literal that converts back to its float32
    value exactly."""
    f = np.float32(v)
    if np.isnan(f):
        return "NAN"
    if np.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    return f"{float(f)!r}f"


class _Cpp:
    """Renders the body of a rewritten elementwise function (the output of
    :func:`analyse_elem`) as C++ statements.  ``hint`` ends every error
    message (what the caller may do instead)."""

    def __init__(self, name: str, consts: dict, prefix: str, hint: str):
        self.name, self.consts, self.prefix, self.hint = name, consts, prefix, hint
        self.declared: set = set()
        self.tmp = 0

    def fail(self, node, what: str):
        raise ValueError(f"{self.name}: {what} ({ast.unparse(node)!r}) is "
                         f"outside the elementwise contract; {self.hint}")

    def expr(self, node) -> str:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return "true" if node.value else "false"
            if isinstance(node.value, (int, float)):
                return _f32_literal(node.value)
            self.fail(node, "a constant that is not a number")
        if isinstance(node, ast.Name):
            key = node.id[len(self.prefix):] if node.id.startswith(self.prefix) else None
            if key in self.consts:
                v = self.consts[key]
                return ("true" if v else "false") if isinstance(v, bool) else _f32_literal(v)
            if node.id in _FUNCS or node.id == "_elem_where":
                self.fail(node, "an elem function other than called")
            return f"v_{node.id}"
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
            return self.power(node)
        if isinstance(node, ast.BinOp):
            fn = _BINOPS.get(type(node.op))
            if fn is None:
                self.fail(node, f"the operator {type(node.op).__name__}")
            return f"{fn}({self.expr(node.left)}, {self.expr(node.right)})"
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return f"(-{self.expr(node.operand)})"
            if isinstance(node.op, ast.UAdd):
                return self.expr(node.operand)
            self.fail(node, f"the operator {type(node.op).__name__}")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or type(node.ops[0]) not in _CMPOPS:
                self.fail(node, "a chained or non-numeric comparison")
            return (f"({self.expr(node.left)} {_CMPOPS[type(node.ops[0])]} "
                    f"{self.expr(node.comparators[0])})")
        if isinstance(node, ast.Call):
            fname = node.func.id if isinstance(node.func, ast.Name) else None
            if node.keywords:
                self.fail(node, "a call with keyword arguments")
            if fname == "_elem_where":
                if len(node.args) != 3:
                    self.fail(node, "where without three arguments")
                c, a, b = (self.expr(v) for v in node.args)
                return f"({c} ? {a} : {b})"
            if fname not in _FUNCS:
                self.fail(node, "a call outside the elem namespace")
            fn, arity = _FUNCS[fname]
            if len(node.args) != arity:
                self.fail(node, f"a call with {len(node.args)} arguments")
            return f"{fn}({', '.join(self.expr(v) for v in node.args)})"
        self.fail(node, f"the expression {type(node).__name__}")

    def number(self, node):
        """The value of a number constant, a negated one or a captured
        number; ``None`` for anything else."""
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            v = self.number(node.operand)
            return None if v is None else (-v if isinstance(node.op, ast.USub) else v)
        if isinstance(node, ast.Constant):
            v = node.value
        elif isinstance(node, ast.Name) and node.id.startswith(self.prefix):
            v = self.consts.get(node.id[len(self.prefix):])
        else:
            return None
        return None if isinstance(v, bool) or not isinstance(v, (int, float)) else v

    def power(self, node) -> str:
        """``a ** c`` for a number ``c``, rounded as torch's float32 ``pow``
        rounds it: its special cases (2, 3, 0.5, -1) as torch computes them,
        CUDA's ``powf`` for any other exponent."""
        c = self.number(node.right)
        if c is None:
            self.fail(node, "the operator Pow with an exponent that is not a number")
        a = self.expr(node.left)
        if c == 2:
            return f"__fmul_rn({a}, {a})"
        if c == 3:
            return f"__fmul_rn(__fmul_rn({a}, {a}), {a})"
        if c == 0.5:
            return f"__fsqrt_rn({a})"
        if c == -1:
            return f"__frcp_rn({a})"
        return f"powf({a}, {_f32_literal(c)})"

    def assign(self, name: str, value: str) -> str:
        if name in self.declared:
            return f"v_{name} = {value};"
        self.declared.add(name)
        return f"auto v_{name} = {value};"

    def values(self, elts) -> tuple:
        """Temporaries holding each of ``elts``, evaluated in order: (their
        names, the declarations)."""
        tmps, out = [], []
        for v in elts:
            tmps.append(f"tu{self.tmp}")
            out.append(f"const auto {tmps[-1]} = {self.expr(v)};")
            self.tmp += 1
        return tmps, out

    def stmt(self, node, outs: int) -> list:
        """C++ lines of one statement; a return gives ``outs`` values (one:
        ``return``; more: the output references ``o_0 ..``)."""
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            return []                                    # a docstring
        if isinstance(node, ast.Return):
            if outs == 1:
                if node.value is None or isinstance(node.value, ast.Tuple):
                    self.fail(node, "a return of other than one value")
                return [f"return {self.expr(node.value)};"]
            if not (isinstance(node.value, ast.Tuple) and len(node.value.elts) == outs):
                self.fail(node, f"a return of other than a tuple of {outs} values")
            tmps, out = self.values(node.value.elts)
            return out + [f"o_{i} = {t};" for i, t in enumerate(tmps)] + ["return;"]
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name):
                return [self.assign(target.id, self.expr(node.value))]
            if (isinstance(target, ast.Tuple) and isinstance(node.value, ast.Tuple)
                    and len(target.elts) == len(node.value.elts)
                    and all(isinstance(e, ast.Name) for e in target.elts)):
                # the right side first, then the names, as Python does
                tmps, out = self.values(node.value.elts)
                return out + [self.assign(e.id, t) for e, t in zip(target.elts, tmps)]
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            value = self.expr(ast.BinOp(left=ast.Name(id=node.target.id, ctx=ast.Load()),
                                        op=node.op, right=node.value))
            return [self.assign(node.target.id, value)]
        self.fail(node, f"the statement {type(node).__name__}")


def render_function(src: str, consts: dict, prefix: str, *, outs: int = 1,
                    hint: str) -> str:
    """The C++ ``__device__`` function of an analysed elementwise function
    (``src``, ``consts`` and ``prefix`` from :func:`analyse_elem`), one
    ``float v_<arg>`` a Python argument.  With ``outs`` = 1 it returns its
    one value (``float name(..)``); with more it returns the tuple through
    ``float& o_0, ..`` (``void name(.., float& o_0, ..)``).  Raises
    ``ValueError``, ending in ``hint``, on anything outside the contract."""
    fn_node = ast.parse(src).body[0]
    name = fn_node.name
    r = _Cpp(name, consts, prefix, hint)
    args = [a.arg for a in fn_node.args.args]
    r.declared.update(args)
    body = [line for s in fn_node.body for line in r.stmt(s, outs)]
    ends = [i for i, b in enumerate(body) if b.startswith("return")]
    if ends != [len(body) - 1]:
        what = f"a tuple of {outs} values" if outs > 1 else "one value"
        raise ValueError(f"{name} must end in its one return, of {what}; {hint}")
    params = [f"float v_{a}" for a in args] + [f"float& o_{i}" for i in range(outs)
                                                if outs > 1]
    lines = "\n".join(f"  {b}" for b in body)
    kind = "void" if outs > 1 else "float"
    return (f"__device__ __forceinline__ {kind} {name}({', '.join(params)}) "
            f"{{\n{lines}\n}}\n")
