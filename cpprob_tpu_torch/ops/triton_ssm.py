"""The user-physics chunk kernel (Triton) — counterpart of
``_make_scalar_chunk_kernel`` and ``_make_vector_chunk_kernel``
(``cpprob_tpu/ops/pallas_ssm.py:588-630,730-772``).

One Triton kernel template serves both: D = 1 is K10 (scalar states, (n,)
float32), D > 1 is K11 (vector states, (n, D) float32, read and written
plane by plane).  Per particle it runs ``n_steps`` of the user's physics
with ``n_valid`` masking, and writes one (max, sum e, sum e^2) record per
program of ``BLOCK`` particles (e = exp(w - max w), the layout
:func:`~.fused_hmm.stats_from_partials` combines).

**The step_elem contract.**  The physics is a plain ``def`` function
(not a lambda)

    step_elem(x_0, ..., x_{D-1}, y, eps_0, ..., eps_{D-1})
        -> (x'_0, ..., x'_{D-1}, log_emission)

over elementwise float32 values: ``x_d`` the state planes, ``y`` the
step's observation (a scalar), ``eps_d`` independent standard normals.  Its
body may use arithmetic operators, comparisons, local names, tuple
unpacking, and the functions of :mod:`cpprob_tpu_torch.ops.elem`
(``exp``, ``log``, ``sqrt``, ``sin``, ``cos``, ``tanh``, ``where``,
``minimum``, ``maximum``), named through the module (``elem.exp``) or
imported from it.  It may capture numbers (int, float, bool, numpy
scalars), from its closure or its module, and number attributes of
modules (``math.pi``); each becomes a compile-time constant of the
kernel.  Nothing else: no tensors, no other functions.  Every returned
value must depend on a state plane or on eps (a plane, not a scalar).

The plain version (:func:`user_chunk_plain`) calls the same function on
torch tensors.  The kernel path reads the function's source, checks it
against the contract and raises ``ValueError`` when the model is built
(:class:`UserKernel`), and compiles it into the kernel at the first
launch; a Triton compile error raises there.  A CUDA tensor is never given
to the plain version.

**Draws.**  The Box-Muller pair of absolute step t for plane d sits on
Philox4x32-10 counter (particle, t // 2, d, 0) under the sweep's seed: its
cos half at even t, its sin half at odd t (a launch starting at odd t
recomputes the pair).  So draws do not depend on how a sweep is chunked,
and at D = 1 they are the linear-Gaussian kernel's (``csrc/fused_lg.cu``):
K10 with the LG physics is K7 draw for draw.  Triton's ``tl.philox`` is
Philox4x32-10 with the seed's low and high words as the key, the
generator of ``ops/philox.py``; the transcendentals are libdevice's precise
ones, square root and division round to nearest (``tl.sqrt_rn``,
``tl.div_rn``: the kernel's default ones are approximate), and the kernel
is compiled with ``enable_fp_fusion=False``, so it rounds as the plain
version does.

What bounds it on an H100: per particle-step half a Philox call and a
log/sqrt/sin-or-cos per plane, plus the physics, against 8(D + 1) bytes
read and written per chunk: issue-bound, not memory-bound.  The design
keeps the planes and the weight of ``BLOCK / (32 num_warps)`` particles per
thread in registers across the chunk.

The generated kernel source goes to ``ops/_build/`` (one file per physics
and D), and Triton's cache to ``ops/_build/triton_cache``.
"""

from __future__ import annotations

import ast
import hashlib
import importlib.util
import inspect
import math
import numbers
import os
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import torch

from . import elem as _elem
from .fused_lg import _normal_pair
from .population import launch_population

__all__ = ["BLOCK", "LAUNCHES", "UserKernel", "user_chunk_plain",
           "philox_words"]

BLOCK = 4096             # particles per program: one record each
_NUM_WARPS = 8
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel launches, counted where the kernel is launched: "scalar" (K10,
# D = 1), "scalar_step" (its one-step launch), "vector" (K11, D > 1)
LAUNCHES = {"scalar": 0, "scalar_step": 0, "vector": 0}


# --------------------------------------------------------------------------
# plain version


def user_chunk_plain(step_elem, D: int, seed: int, states: torch.Tensor,
                     log_w: torch.Tensor, ys: torch.Tensor, n_valid=None, *,
                     t0: int = 1, draws=None):
    """Plain version of the chunk kernel.  ``states`` (n,) for D = 1, else
    (n, D); ``n_valid``: int32 scalar tensor (``None``: every step valid);
    ``t0``: absolute time of the first step.  ``draws``: eps of shape
    (n_steps, D, n) or broadcastable, in place of Philox.  Returns (states,
    log_w, records (ceil(n / BLOCK), 3))."""
    n, n_steps = states.shape[0], ys.shape[0]
    dev = states.device
    xs = [states] if D == 1 else list(states.unbind(1))
    w = log_w
    nv = (torch.tensor(n_steps) if n_valid is None
          else torch.as_tensor(n_valid).reshape(())).to(dev)
    g = torch.arange(n, device=dev)
    sin_half = [None] * D
    for t in range(n_steps):
        ta = t0 + t
        eps = []
        for d in range(D):
            if draws is not None:
                eps.append(torch.broadcast_to(draws[t][d], (n,)))
            elif ta % 2 == 0 or sin_half[d] is None:
                cos_half, sin_half[d] = _normal_pair(seed, g, ta // 2, d)
                eps.append(cos_half if ta % 2 == 0 else sin_half[d])
            else:
                eps.append(sin_half[d])
        out = step_elem(*xs, ys[t], *eps)
        valid = t < nv
        xs = [torch.where(valid, nx, x) for nx, x in zip(out[:D], xs)]
        w = torch.where(valid, w + out[D], w)
    pad = -n % BLOCK
    w2 = torch.nn.functional.pad(w, (0, pad), value=-math.inf).view(-1, BLOCK)
    m = w2.amax(1)
    e = torch.exp(w2 - m[:, None])
    rec = torch.stack([m, e.sum(1), (e * e).sum(1)], 1)
    new = xs[0] if D == 1 else torch.stack(xs, 1)
    return new, w, rec


# --------------------------------------------------------------------------
# the step_elem contract: source analysis (no Triton needed)


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
    """Maps the elem namespace to the kernel's ``_elem_*`` functions and
    module attributes that are numbers to constants."""

    def __init__(self, env: dict, consts: dict):
        self.env, self.consts = env, consts

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id in self.env:
            mod = self.env[node.value.id]
            if mod is _elem:
                if node.attr not in _elem.NAMES:
                    raise ValueError(f"step_elem: elem.{node.attr} is not in "
                                     f"the namespace {_elem.NAMES}")
                return ast.copy_location(
                    ast.Name(id=f"_elem_{node.attr}", ctx=node.ctx), node)
            if isinstance(mod, types.ModuleType):
                val = _number(getattr(mod, node.attr, None))
                if val is not None:
                    return ast.copy_location(ast.Constant(val), node)
        raise ValueError(f"step_elem: attribute {ast.unparse(node)} is outside "
                         "the contract (elem functions and module numbers)")

    def visit_BinOp(self, node):
        # a / b rounds to nearest, as torch's division does (the kernel's
        # default division is approximate)
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Div):
            return ast.copy_location(ast.Call(
                func=ast.Name(id="_div_rn", ctx=ast.Load()),
                args=[node.left, node.right], keywords=[]), node)
        return node

    def visit_Name(self, node):
        if node.id in self.consts:
            return ast.copy_location(
                ast.Name(id=f"_k_{node.id}", ctx=node.ctx), node)
        v = self.env.get(node.id, node)
        if v is not node and callable(v):
            for name in _elem.NAMES:
                if v is getattr(_elem, name):
                    return ast.copy_location(
                        ast.Name(id=f"_elem_{name}", ctx=node.ctx), node)
        return node


def analyse_step_elem(step_elem, D: int):
    """Check ``step_elem`` against the contract (module docstring).
    Returns (the function's source rewritten for the kernel, named
    ``step_elem``, and the captured constants {name: number}).  Raises
    ``ValueError`` on anything outside the contract."""
    if not isinstance(step_elem, types.FunctionType):
        raise ValueError("step_elem must be a plain Python function")
    if step_elem.__name__ == "<lambda>":
        raise ValueError("step_elem must be a def function, not a lambda: "
                         "the kernel is compiled from its source")
    try:
        src = textwrap.dedent(inspect.getsource(step_elem))
    except (OSError, TypeError) as e:
        raise ValueError(f"step_elem has no readable source: {e}") from None
    fn_node = next(n for n in ast.parse(src).body
                   if isinstance(n, ast.FunctionDef))
    if any(isinstance(n, (ast.Import, ast.ImportFrom, ast.Global,
                          ast.Nonlocal)) for n in ast.walk(fn_node)):
        raise ValueError("step_elem may not import or declare globals: "
                         "import the elem namespace at module level")
    a = fn_node.args
    if (a.vararg or a.kwarg or a.kwonlyargs or a.defaults or a.posonlyargs
            or len(a.args) != 2 * D + 1):
        raise ValueError(f"step_elem must take {2 * D + 1} positional "
                         f"arguments (x_0..x_{D - 1}, y, eps_0..eps_{D - 1})")
    cv = inspect.getclosurevars(step_elem)
    env = {**cv.builtins, **cv.globals, **cv.nonlocals}
    consts = {}
    for name in sorted(_free_names(fn_node)):
        if name not in env:
            raise ValueError(f"step_elem: unknown name {name!r}")
        v = env[name]
        num = _number(v)
        if num is not None:
            consts[name] = num
        elif v is _elem or any(v is getattr(_elem, f) for f in _elem.NAMES):
            continue
        elif isinstance(v, types.ModuleType):
            continue     # only its number attributes pass _Rewrite
        else:
            raise ValueError(
                f"step_elem: {name!r} is a {type(v).__name__}; the kernel "
                "takes captured numbers and the elem namespace only")
    fn_node.decorator_list = []
    fn_node.name = "step_elem"
    fn_node = _Rewrite(env, consts).visit(fn_node)
    ast.fix_missing_locations(fn_node)
    return ast.unparse(fn_node), consts


# --------------------------------------------------------------------------
# the kernel: generated source, built at the first launch


_TEMPLATE = '''\
# Generated by cpprob_tpu_torch/ops/triton_ssm.py from a user step_elem.
import triton
import triton.language as tl
{libdevice_import}

{constants}

@triton.jit
def _elem_exp(x):
    return libdevice.exp(x)


@triton.jit
def _elem_log(x):
    return libdevice.log(x)


@triton.jit
def _elem_sqrt(x):
    return tl.sqrt_rn(x)


@triton.jit
def _div_rn(a, b):
    return tl.div_rn(a, b)


@triton.jit
def _elem_sin(x):
    return libdevice.sin(x)


@triton.jit
def _elem_cos(x):
    return libdevice.cos(x)


@triton.jit
def _elem_tanh(x):
    return libdevice.tanh(x)


@triton.jit
def _elem_where(c, a, b):
    return tl.where(c, a, b)


@triton.jit
def _elem_minimum(a, b):
    return tl.minimum(a, b)


@triton.jit
def _elem_maximum(a, b):
    return tl.maximum(a, b)


@triton.jit
{step_elem}


@triton.jit
def _normal_pair(seed, g, pair, plane: tl.constexpr):
    # Box-Muller on Philox4x32-10 counter (g, pair, plane, 0), words 0 and 1
    b0, b1, _b2, _b3 = tl.philox(seed, g, pair, plane, 0)
    u1 = tl.maximum((b0 >> 8).to(tl.float32) * (1.0 / 16777216.0), 1e-12)
    u2 = (b1 >> 8).to(tl.float32) * (1.0 / 16777216.0)
    r = tl.sqrt_rn(-2.0 * libdevice.log(u1))
    ang = 6.283185307179586 * u2
    return r * libdevice.cos(ang), r * libdevice.sin(ang)


@triton.jit(do_not_specialize=["seed", "t0", "n", "n_steps"])
def user_chunk_kernel(x_ptr, w_ptr, ys_ptr, nv_ptr, xo_ptr, wo_ptr, rec_ptr,
                      n, n_steps, seed, t0, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    g = offs.to(tl.uint32)
{load_planes}
    w = tl.load(w_ptr + offs, mask=mask, other=-float("inf"))
    n_valid = tl.minimum(tl.load(nv_ptr), n_steps)
    for t in range(0, n_valid):
        ta = t0 + t
        y = tl.load(ys_ptr + t)
        even = (ta % 2) == 0
        if even | (t == 0):
{draw_pairs}
        else:
{reuse_sin}
        {step_out} = step_elem({step_args})
{advance}
    w = tl.where(mask, w, -float("inf"))
{store_planes}
    tl.store(wo_ptr + offs, w, mask=mask)
    m = tl.max(w, axis=0)
    e = tl.where(mask, libdevice.exp(w - m), 0.0)
    tl.store(rec_ptr + pid * 3, m)
    tl.store(rec_ptr + pid * 3 + 1, tl.sum(e, axis=0))
    tl.store(rec_ptr + pid * 3 + 2, tl.sum(e * e, axis=0))


@triton.jit
def philox_words_kernel(out_ptr, seed, c1, c2, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    b0, b1, b2, b3 = tl.philox(seed, offs.to(tl.uint32), c1, c2, 0)
    tl.store(out_ptr + offs * 4, b0.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 1, b1.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 2, b2.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 3, b3.to(tl.int32, bitcast=True), mask=mask)
'''


def _libdevice_import() -> str:
    """The import of Triton's libdevice functions (their module moved
    between Triton releases)."""
    try:
        importlib.import_module("triton.language.extra.libdevice")
        return "from triton.language.extra import libdevice"
    except ImportError:
        return "from triton.language.extra.cuda import libdevice"


def render_source(step_src: str, consts: dict, D: int) -> str:
    """The generated module's source for a rewritten ``step_elem`` of D
    planes (needs ``triton`` installed only for the libdevice path)."""
    ind = " " * 4
    planes = range(D)
    fill = {
        "libdevice_import": _libdevice_import(),
        "constants": "\n".join(f"_k_{k} = tl.constexpr({v!r})"
                               for k, v in sorted(consts.items())),
        "step_elem": step_src,
        "load_planes": "\n".join(
            f"{ind}x{d} = tl.load(x_ptr + offs * {D} + {d}, mask=mask, other=0.0)\n"
            f"{ind}sn{d} = tl.zeros([BLOCK], tl.float32)" for d in planes),
        "draw_pairs": "\n".join(
            f"{ind * 3}e{d}, sn{d} = _normal_pair(seed, g, (ta // 2).to(tl.uint32), {d})\n"
            f"{ind * 3}e{d} = tl.where(even, e{d}, sn{d})" for d in planes),
        "reuse_sin": "\n".join(f"{ind * 3}e{d} = sn{d}" for d in planes),
        "step_out": ", ".join([f"nx{d}" for d in planes] + ["lw"]),
        "step_args": ", ".join([f"x{d}" for d in planes] + ["y"]
                               + [f"e{d}" for d in planes]),
        "advance": "\n".join([f"{ind * 2}x{d} = nx{d}" for d in planes]
                             + [f"{ind * 2}w = w + lw"]),
        "store_planes": "\n".join(
            f"{ind}tl.store(xo_ptr + offs * {D} + {d}, x{d}, mask=mask)"
            for d in planes),
    }
    return _TEMPLATE.format(**fill)


def _load_generated(source: str):
    """Write ``source`` to ``ops/_build/`` under a name carrying its hash
    and import it (Triton reads a kernel's source from its file)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton_cache"))
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    name = f"cpprob_user_kernel_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _BUILD_DIR / f"{name}.py"
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class UserKernel:
    """The chunk kernel of one ``step_elem`` over ``D`` planes.  Building it
    checks the physics against the contract (``ValueError``); the Triton
    kernel itself is generated and compiled at the first CUDA launch."""

    def __init__(self, step_elem, D: int):
        if D < 1:
            raise ValueError(f"state dimension must be >= 1, got {D}")
        self.step_elem, self.D = step_elem, int(D)
        self._step_src, self._consts = analyse_step_elem(step_elem, self.D)
        self._module = None
        self._all_steps: dict = {}

    def source(self) -> str:
        """The generated kernel module's source."""
        return render_source(self._step_src, self._consts, self.D)

    def module(self):
        if self._module is None:
            self._module = _load_generated(self.source())
        return self._module

    def chunk(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, n_valid=None, *, t0: int = 1,
              step: bool = False):
        """The chunk on the device of ``states``: the kernel on CUDA tensors,
        :func:`user_chunk_plain` on CPU tensors.  ``step``: a one-step
        launch (counted apart).  Returns (states, log_w, records)."""
        D, dev = self.D, states.device
        want = (states.shape[0],) if D == 1 else (states.shape[0], D)
        if tuple(states.shape) != want or log_w.shape != states.shape[:1]:
            raise ValueError(f"states must be {'(n,)' if D == 1 else f'(n, {D})'} "
                             "and log_w (n,)")
        if dev.type == "cpu":
            return user_chunk_plain(self.step_elem, D, seed, states, log_w,
                                    ys, n_valid, t0=t0)
        n, n_steps = states.shape[0], ys.shape[0]
        if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 32:
            raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^32")
        if n_valid is None:
            if dev not in self._all_steps:
                self._all_steps[dev] = torch.full((1,), 2 ** 30, dtype=torch.int32,
                                             device=dev)
            n_valid = self._all_steps[dev]
        elif n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
        seed64 = int(seed) & 0xFFFFFFFFFFFFFFFF
        grid = -(-n // BLOCK)
        key = "vector" if D > 1 else ("scalar_step" if step else "scalar")

        def launch(x_out, w_out, rec):
            self.module().user_chunk_kernel[(grid,)](
                states, log_w, ys, n_valid, x_out, w_out, rec, n, n_steps,
                seed64, t0, BLOCK=BLOCK, num_warps=_NUM_WARPS,
                enable_fp_fusion=False)

        return launch_population(
            f"user_chunk_kernel (D={D})", launch, device=dev,
            inputs=[(states, "states", torch.float32),
                    (log_w, "log_w", torch.float32),
                    (ys, "ys", torch.float32),
                    (n_valid, "n_valid", torch.int32)],
            outputs=[(want, torch.float32), ((n,), torch.float32)],
            records=(grid, 3), counts=LAUNCHES, count_key=key)


def philox_words(seed: int, n: int, c1: int, c2: int, device) -> torch.Tensor:
    """(n, 4) Philox4x32-10 words of ``tl.philox`` at counters (i, c1, c2,
    0), i < n, as int64 values in [0, 2^32): held against
    :func:`~.philox.philox4x32` on the card."""
    mod = _load_generated(render_source("def step_elem(x, y, e):\n"
                                        "    return x, y", {}, 1))
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    mod.philox_words_kernel[(-(-n // 1024),)](
        out, int(seed) & 0xFFFFFFFFFFFFFFFF, c1, c2, n, BLOCK=1024)
    return out.long() & 0xFFFFFFFF
