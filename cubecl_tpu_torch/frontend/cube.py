"""@cube — the kernel decorator (the reference's ``#[cube]`` proc-macro,
cubecl-macros/src/lib.rs:55-127).

- calling a @cube function inside another trace expands it inline;
- ``kernel.launch(client, cube_count, cube_dim, *args)`` traces (checked
  mode), compiles through the client's compiler with caching keyed on
  KernelId, and dispatches;
- ``launch_unchecked`` skips bounds-check insertion;
- ``apply(client, cube_count, cube_dim, *tensors)`` launches on torch
  tensors and returns the mutable ones, written in place;
- comptime parameters are plain Python values baked into the KernelId —
  the same cache rule as the generated ``KernelMetadata::id``
  (cubecl-macros/src/generate/launch.rs:28-54, generate/kernel.rs:349-432).

Launch arguments (reference BufferArg/TensorArg/ScalarArg,
cubecl-core/src/frontend/container/{slice,tensor}/launch.rs):

- ``ArrayArg(handle, line_size=1, mutable=None)`` → ``Slice``/``MutSlice``
- ``TensorArg(handle, shape, strides, line_size=1, mutable=None)``
- ``ScalarArg(value, elem)`` → runtime scalar (a kernel argument)
- raw ``Handle`` or torch tensor → read-only ArrayArg with line_size 1
- anything else (python numbers, dtypes, cube fns, Sequence) → comptime
"""

from __future__ import annotations

import functools
import hashlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..backend.compiler import KernelDefinition, KernelOptions
from ..ir.features import WARP
from ..ir.scope import GlobalState, Scope
from ..ir.types import ElemType, Type, elem_from_dtype
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from ..runtime.kernel import KernelId, KernelTask
from .array import MutSlice, Slice
from .builder import CubeBuilder, EarlyReturn
from .element import CubeVal, pop_builder, push_builder, tracing
from .sequence import Sequence
from .tensor import MutTensor, Tensor
from .transform import transform_function


@dataclass
class ArrayArg:
    handle: Any                  # Handle or torch tensor
    line_size: int = 1
    mutable: Optional[bool] = None
    length: Optional[int] = None  # elements; default from handle
    # dynamic=True: the handle's physical size is the CAPACITY the kernel
    # compiles against; ``length`` is the runtime LOGICAL length, passed
    # as an implicit i32 scalar each launch. The KernelId keys on the
    # capacity only — launches across logical lengths share one compiled
    # kernel (the shape-polymorphic ABI; reference metadata.rs).
    dynamic: bool = False

    @staticmethod
    def from_raw_parts(handle, length: int, line_size: int = 1,
                       mutable: Optional[bool] = None) -> "ArrayArg":
        """reference BufferArg::from_raw_parts (slice/launch.rs)."""
        return ArrayArg(handle, line_size, mutable, length)


@dataclass
class TensorArg:
    handle: Any
    shape: Optional[Tuple[int, ...]] = None
    strides: Optional[Tuple[int, ...]] = None
    line_size: int = 1
    mutable: Optional[bool] = None


@dataclass
class ScalarArg:
    value: Any
    elem: Optional[ElemType] = None


def _c_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        out[i] = out[i + 1] * shape[i + 1]
    return tuple(out)


def _meta_of(handle):
    """(shape, dtype) WITHOUT touching handle.array — the array property
    flushes the stream scheduler, which must not happen on the classify /
    memo launch path (it would defeat dispatch batching)."""
    return (tuple(handle.shape), handle.dtype)


class CubeFunction:
    """The decorated object."""

    def __init__(self, fn: Callable, **options: Any):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.options = options
        self._impl: Optional[Callable] = None
        self._plans: dict = {}
        self._sig = inspect.signature(fn)
        src = inspect.getsource(fn) if _has_source(fn) else fn.__qualname__
        self._code_hash = hashlib.sha256(src.encode()).hexdigest()[:12]

    @property
    def impl(self) -> Callable:
        if self._impl is None:
            self._impl = transform_function(self.fn)
        return self._impl

    # ------------------------------------------------------ inline expand

    def __call__(self, *args, **kwargs):
        if not tracing():
            raise RuntimeError(
                f"{self.fn.__qualname__} is a @cube function; use "
                f".launch(client, cube_count, cube_dim, ...) to run it, or "
                f"call it from inside another @cube function")
        from .element import active_builder

        b = active_builder()
        # a helper's own fast_math flags apply to the instructions it
        # registers (reference: per-function #[cube(fast_math = ...)],
        # macros parse/kernel.rs) — layered over the caller's flags
        fm = self.options.get("fast_math")
        saved = None
        if fm:
            saved = dict(b.scope.state.fast_math)
            b.scope.state.fast_math = {**saved, **fm}
        b.push_function(entry=False)
        try:
            result = self.impl(b, *args, **kwargs)
        except EarlyReturn as e:
            result = e.value
            frame = b.pop_function()
            return b.combine_returns(frame, result)
        else:
            frame = b.pop_function()
            return b.combine_returns(frame, result)
        finally:
            if saved is not None:
                b.scope.state.fast_math = saved

    # ------------------------------------------------------------- launch

    def launch(self, client, cube_count, cube_dim, *args, **kwargs):
        return self._launch(client, cube_count, cube_dim, args, kwargs,
                            checked=True)

    def launch_unchecked(self, client, cube_count, cube_dim, *args, **kwargs):
        return self._launch(client, cube_count, cube_dim, args, kwargs,
                            checked=False)

    def _launch(self, client, cube_count, cube_dim, args, kwargs,
                checked: bool):
        from ..runtime.base import RuntimeCubeCount

        cc = _as_count(cube_count)
        cd = _as_dim(cube_dim)
        rt = isinstance(cc, RuntimeCubeCount)
        if 0 in cc.as_tuple():
            # zero-grid guard (reference client.rs launch_inner): a 0-sized
            # grid is a no-op, never a 1-cube launch (the emitter squeezes
            # size-1 dims, which would otherwise resurrect an empty grid)
            return []

        # launch-plan memo: identical (shapes, dtypes, comptimes, config)
        # launches skip classification + kernel-id hashing — the hot-loop
        # fast path (the reference macro generates this statically).
        # Runtime grids/lengths key on CAPACITY; the varying values ride
        # in the scalars below.
        key = None
        if not kwargs:
            try:
                key = (cc.cache_key() if rt else cc, cd, checked,
                       tuple(_arg_desc(a) for a in args),
                       _alias_groups(_arg_handles(args)))
            except TypeError:
                pass
        if key is not None:
            plan = self._plans.get(key)
            if plan is not None:
                task, buf_paths, scalar_paths = plan
                buffers = [_extract_handle(_resolve_path(args, p))
                           for p in buf_paths]
                scalars = [_resolve_scalar(args, p) for p in scalar_paths]
                if rt:
                    scalars.append(cc.x)
                client.launch(task, buffers, scalars)
                return buffers

        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        params = self._classify(bound)

        kid = self._kernel_id(cc, cd, params, checked)
        task = KernelTask(
            kid, lambda: self._define(cc, cd, params, checked),
            name=self.fn.__name__)
        buffers = _param_handles(params)
        scalars = [p["value"] for p in params if p["kind"] == "scalar"]
        if rt:
            scalars.append(cc.x)
        client.launch(task, buffers, scalars)

        if key is not None:
            paths = _index_paths(args)
            if paths is not None:
                self._plans[key] = (task, paths[0], paths[1])
        return buffers

    def apply(self, client, cube_count, cube_dim, *args,
              checked: bool = False):
        """Launch on torch tensors (or ``ArrayArg``s over them) and return
        the mutable output tensor, or a tuple of them.

        The JAX package's ``apply`` is a functional launch that returns
        new arrays; in torch the kernel writes the mutable tensors it was
        given in place, and ``apply`` hands those same tensors back, so
        model code reads like the JAX version."""
        self._launch(client, cube_count, cube_dim, args, {}, checked)
        outs = [p["handle"].tensor
                for p in self._classify(self._sig.bind(*args))
                for p in _flat_buffers(p) if p["mutable"]]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def define(self, cube_count, cube_dim, *args, checked: bool = True,
               **kwargs) -> KernelDefinition:
        """Trace the kernel for a launch with these arguments, without a
        client: the unoptimized ``KernelDefinition`` a backend compiles."""
        cc = _as_count(cube_count)
        cd = _as_dim(cube_dim)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return self._define(cc, cd, self._classify(bound), checked)

    def compile_only(self, client, cube_count, cube_dim, *args,
                     checked: bool = True, **kwargs):
        """Dry-run compile (reference LaunchMode::Skip, dry_run.rs)."""
        cc = _as_count(cube_count)
        cd = _as_dim(cube_dim)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        params = self._classify(bound)
        kid = self._kernel_id(cc, cd, params, checked)
        task = KernelTask(kid, lambda: self._define(cc, cd, params, checked),
                          name=self.fn.__name__)
        return client.server.compile_kernel(task)

    # --------------------------------------------------------------- impl

    def _classify(self, bound) -> List[dict]:
        params = []
        for name, value in bound.arguments.items():
            ann = self._sig.parameters[name].annotation
            ann_name = getattr(ann, "__name__", str(ann))
            mut_ann = "Mut" in str(ann_name)
            tensor_ann = "Tensor" in str(ann_name)
            if isinstance(value, (ArrayArg, TensorArg)) or \
                    isinstance(value, Handle) or _is_device_array(value):
                if isinstance(value, TensorArg):
                    hshape, _hdt = _meta_of(value.handle)
                    shape = value.shape or hshape
                    strides = value.strides or _c_strides(shape)
                    params.append(dict(
                        kind="buffer", name=name, handle=_as_handle(value.handle),
                        line=value.line_size,
                        mutable=value.mutable if value.mutable is not None
                        else mut_ann,
                        tensor=True, shape=shape, strides=strides))
                else:
                    aa = value if isinstance(value, ArrayArg) else \
                        ArrayArg(value)
                    shape, _hdt = _meta_of(aa.handle)
                    if getattr(aa, "dynamic", False):
                        # shape-polymorphic buffer: capacity compiles the
                        # kernel, the logical length rides as an implicit
                        # i32 scalar (in lines) — registered BEFORE the
                        # buffer so _define can hand the scalar to the
                        # Slice proxy as its runtime .len()
                        from ..ir.types import i32

                        assert not tensor_ann, \
                            "dynamic buffers are Slice-only (v1)"
                        cap = int(np.prod(shape)) if shape else 1
                        n = aa.length if aa.length is not None else cap
                        assert 0 <= n <= cap, \
                            f"{name}: logical length {n} > capacity {cap}"
                        assert n % aa.line_size == 0 and \
                            cap % aa.line_size == 0
                        params.append(dict(
                            kind="scalar", name=f"{name}__len",
                            value=n // aa.line_size, elem=i32,
                            implicit=True, dynlen_for=name))
                        params.append(dict(
                            kind="buffer", name=name,
                            handle=_as_handle(aa.handle),
                            line=aa.line_size,
                            mutable=aa.mutable if aa.mutable is not None
                            else mut_ann,
                            tensor=False, shape=shape,
                            strides=_c_strides(shape),
                            length=None, dyn=True))
                        continue
                    params.append(dict(
                        kind="buffer", name=name, handle=_as_handle(aa.handle),
                        line=aa.line_size,
                        mutable=aa.mutable if aa.mutable is not None
                        else mut_ann,
                        tensor=tensor_ann, shape=shape,
                        strides=_c_strides(shape),
                        length=aa.length))
            elif isinstance(value, ScalarArg):
                elem = value.elem or _infer_elem(value.value)
                params.append(dict(kind="scalar", name=name,
                                   value=value.value, elem=elem))
            elif isinstance(value, Sequence) and len(value) > 0 and all(
                    isinstance(x, (ArrayArg, TensorArg, Handle))
                    or _is_device_array(x) for x in value):
                # SequenceArg: one buffer param per element (reference
                # sequence/launch.rs:13 — the comptime-fusion path)
                items = []
                for i, x in enumerate(value):
                    aa = x if isinstance(x, ArrayArg) else ArrayArg(x)
                    hshape, _hdt = _meta_of(aa.handle)
                    items.append(dict(
                        kind="buffer", name=f"{name}_{i}",
                        handle=_as_handle(aa.handle), line=aa.line_size,
                        mutable=aa.mutable if aa.mutable is not None
                        else mut_ann,
                        tensor=False, shape=hshape,
                        strides=_c_strides(hshape),
                        length=aa.length))
                params.append(dict(kind="seq", name=name, items=items))
            else:
                params.append(dict(kind="comptime", name=name, value=value))
        return params

    def _kernel_id(self, cc: CubeCount, cd: CubeDim, params, checked) -> KernelId:
        from ..runtime.base import RuntimeCubeCount

        cck = cc.cache_key() if isinstance(cc, RuntimeCubeCount) \
            else cc.as_tuple()
        parts = [self.fn.__module__, self.fn.__qualname__, self._code_hash,
                 f"cc={cck}", f"cd={cd.as_tuple()}",
                 f"checked={checked}"]
        def buffer_part(p):
            # cached shape/dtype — do NOT touch handle.array here (it
            # flushes the stream scheduler; ids need only metadata)
            h = p["handle"]
            elem = elem_from_dtype(h.dtype)
            return (f"b:{p['name']}:{elem}x{p['line']}:{tuple(h.shape)}:"
                    f"{p['mutable']}:{p.get('tensor', False)}:"
                    f"{p.get('dyn', False)}")

        for p in params:
            if p["kind"] == "buffer":
                parts.append(buffer_part(p))
            elif p["kind"] == "seq":
                parts.extend(buffer_part(b) for b in p["items"])
            elif p["kind"] == "scalar":
                parts.append(f"s:{p['name']}:{p['elem']}")
            else:
                parts.append(f"k:{p['name']}:{_comptime_repr(p['value'])}")
        aliases = _alias_groups(_param_handles(params))
        if aliases:
            parts.append(f"alias={aliases}")
        return KernelId.build(*parts)

    def _define(self, cc: CubeCount, cd: CubeDim, params,
                checked: bool) -> KernelDefinition:
        state = GlobalState()
        state.cube_dim = cd.as_tuple()
        state.debug_symbols = bool(self.options.get("debug_symbols", False))
        # kernel-level fast-math flags ride every registered instruction's
        # modes (reference InstructionModes fp_math_mode, scope.rs:100);
        # helper-level flags override inside __call__
        state.fast_math = dict(self.options.get("fast_math") or {})
        scope = Scope(state)
        builder = CubeBuilder(scope)
        plane_dim = _pick_plane(cd.num_units)

        dynlen_vals: dict = {}  # buffer name -> its length-scalar Value

        def buffer_proxy(p):
            h = p["handle"]  # cached metadata only; .array would flush
            elem = elem_from_dtype(h.dtype)
            total = int(np.prod(h.shape)) if h.shape else 1
            if p.get("length"):
                total = p["length"]
            line = p["line"]
            assert total % line == 0, \
                f"buffer {p['name']} length {total} not divisible by " \
                f"line size {line}"
            dl = dynlen_vals.get(p["name"]) if p.get("dyn") else None
            v = scope.add_buffer(p["name"], Type(elem, line), total // line,
                                 p["mutable"],
                                 p.get("shape"), p.get("strides"),
                                 dyn_len=dl)
            if p.get("tensor"):
                cls = MutTensor if p["mutable"] else Tensor
                return cls(v, p["shape"], p["strides"], line)
            cls = MutSlice if p["mutable"] else Slice
            return cls(v, total // line, line,
                       dyn_len=CubeVal(dl) if dl is not None else None)

        proxies = []
        aliases = _alias_groups(_param_handles(params))
        for p in params:
            if p["kind"] == "buffer":
                proxies.append(buffer_proxy(p))
            elif p["kind"] == "seq":
                proxies.append(Sequence([buffer_proxy(b) for b in p["items"]]))
            elif p["kind"] == "scalar":
                v = scope.add_scalar(p["name"], Type(p["elem"]))
                if p.get("implicit"):
                    # a dynamic buffer's length scalar: registered in the
                    # ABI (scalar order = launch order) but NOT a user
                    # parameter — it reaches the kernel as the buffer
                    # proxy's runtime .len()
                    dynlen_vals[p["dynlen_for"]] = v
                    continue
                proxies.append(CubeVal(v))
            else:
                proxies.append(p["value"])
        state.aliased = {bp.value.vid for bp, g in zip(state.buffers, aliases)
                         if aliases.count(g) > 1}

        from ..runtime.base import RuntimeCubeCount

        dynamic_grid_vid = None
        if isinstance(cc, RuntimeCubeCount):
            # the runtime grid width: last scalar in the ABI (launch
            # appends cc.x after all param scalars)
            from ..ir.types import i32

            gv = scope.add_scalar("__grid_x", Type(i32))
            dynamic_grid_vid = gv.vid

        push_builder(builder)
        builder.push_function(entry=True)
        try:
            self.impl(builder, *proxies)
        except EarlyReturn:
            pass
        finally:
            builder.pop_function()
            pop_builder()

        if state.errors:
            raise RuntimeError("kernel validation errors: "
                               + "; ".join(state.errors))
        opts = KernelOptions(
            checked=checked,
            fast_math=self.options.get("fast_math") or {},
            debug_symbols=self.options.get("debug_symbols", False),
            name=self.fn.__name__,
        )
        return KernelDefinition(scope, cd.as_tuple(), cc.as_tuple(), opts,
                                plane_dim, dynamic_grid_vid=dynamic_grid_vid)


def _flat_buffers(p: dict):
    if p["kind"] == "buffer":
        yield p
    elif p["kind"] == "seq":
        yield from p["items"]


def _param_handles(params) -> List[Handle]:
    """The buffers' handles in ABI order."""
    return [b["handle"] for p in params for b in _flat_buffers(p)]


def _arg_handles(args) -> List[Handle]:
    """The handles of the buffer arguments among ``args``, in order."""
    return [_extract_handle(x) for a in args
            for x in (a if isinstance(a, Sequence) else (a,))
            if _is_buffer_arg(x)]


def _alias_groups(handles) -> tuple:
    """For each handle, the index of the first one over the same storage;
    ``()`` when no two share one. Aliased buffers (``launch(c, h, h)``:
    one tensor read and written) are one memory, which the CUDA printer
    must not declare ``__restrict__``, so the grouping is part of the
    kernel id."""
    ptrs = [h.tensor.untyped_storage().data_ptr() for h in handles]
    groups = tuple(ptrs.index(p) for p in ptrs)
    return groups if groups != tuple(range(len(ptrs))) else ()


# ----------------------------------------------------- launch-plan memo


def _arg_desc(a):
    """Hashable structural descriptor of a launch argument (raises
    TypeError for unhashable comptime values → no memo). Uses the
    handle's CACHED shape/dtype — touching .array flushes the stream
    scheduler, which would defeat dispatch batching."""
    if isinstance(a, ArrayArg):
        h = a.handle
        shape, dt = _meta_of(h)
        if getattr(a, "dynamic", False):
            # the logical length is a runtime scalar — NOT part of the
            # memo key (that's the entire point of the dynamic ABI)
            return ("bdyn", shape, str(dt), a.line_size, a.mutable)
        return ("b", shape, str(dt), a.line_size,
                a.mutable, a.length)
    if isinstance(a, TensorArg):
        h = a.handle
        shape, dt = _meta_of(h)
        return ("t", shape, str(dt), a.shape, a.strides,
                a.line_size, a.mutable)
    if isinstance(a, Handle):
        return ("h", a.shape, str(a.dtype))
    if isinstance(a, ScalarArg):
        return ("s", a.elem.name if a.elem else type(a.value).__name__)
    if isinstance(a, Sequence):
        return ("seq",) + tuple(_arg_desc(x) for x in a)
    if isinstance(a, CubeFunction):
        return ("fn", a.fn.__qualname__, a._code_hash)
    if _is_device_array(a):
        return ("a", tuple(a.shape), str(a.dtype))
    hash(a)
    return ("k", a)


def _is_buffer_arg(a) -> bool:
    return isinstance(a, (ArrayArg, TensorArg, Handle)) or _is_device_array(a)


def _index_paths(args):
    """(buffer_paths, scalar_paths) in classification order, or None.
    Scalar paths are tagged: ("v", path) reads ScalarArg.value, ("dl",
    path) computes a dynamic buffer's logical LINE count — matching the
    implicit scalar _classify injects before each dynamic buffer."""
    buf, sca = [], []
    for i, a in enumerate(args):
        if isinstance(a, Sequence):
            if not all(_is_buffer_arg(x) for x in a):
                return None
            buf.extend((i, j) for j in range(len(a)))
        elif _is_buffer_arg(a):
            if isinstance(a, ArrayArg) and getattr(a, "dynamic", False):
                sca.append(("dl", (i,)))
            buf.append((i,))
        elif isinstance(a, ScalarArg):
            sca.append(("v", (i,)))
    return buf, sca


def _resolve_path(args, p):
    a = args[p[0]]
    return a[p[1]] if len(p) > 1 else a


def _resolve_scalar(args, tagged):
    tag, p = tagged
    a = _resolve_path(args, p)
    if tag == "dl":
        shape, _dt = _meta_of(a.handle)
        n = a.length if a.length is not None else \
            (int(np.prod(shape)) if shape else 1)
        return n // a.line_size
    return a.value


def _extract_handle(a) -> Handle:
    if isinstance(a, (ArrayArg, TensorArg)):
        return _as_handle(a.handle)
    if isinstance(a, Handle):
        return a
    return Handle(a)


def _pick_plane(num_units: int) -> int:
    """PLANE_DIM on CUDA: a warp (32) when warps tile the cube, else the
    whole cube when it is smaller than a warp (the other lanes of its warp
    are masked). The JAX package picks the TPU's sublane count, 8. A cube
    larger than a warp and not a whole number of warps keeps 32: its last
    plane is partial, which the printer refuses for plane ops."""
    return WARP if num_units % WARP == 0 or num_units > WARP else num_units


def _has_source(fn) -> bool:
    try:
        inspect.getsource(fn)
        return True
    except (OSError, TypeError):
        return False


def _is_device_array(v) -> bool:
    return hasattr(v, "dtype") and hasattr(v, "shape") and \
        not isinstance(v, (np.generic,))


def _as_handle(h):
    if isinstance(h, Handle):
        return h
    return Handle(h)


def _as_count(cc) -> CubeCount:
    from ..runtime.base import RuntimeCubeCount

    if isinstance(cc, (CubeCount, RuntimeCubeCount)):
        return cc
    if isinstance(cc, int):
        return CubeCount(cc)
    return CubeCount(*cc)


def _as_dim(cd) -> CubeDim:
    if isinstance(cd, CubeDim):
        return cd
    if isinstance(cd, int):
        return CubeDim(cd)
    return CubeDim(*cd)


def _infer_elem(v) -> ElemType:
    from ..ir.types import f32, i32

    if hasattr(v, "dtype"):
        return elem_from_dtype(v.dtype)
    return f32 if isinstance(v, float) else i32


def _comptime_repr(v) -> str:
    if isinstance(v, CubeFunction):
        return f"fn:{v.fn.__qualname__}:{v._code_hash}"
    if isinstance(v, Sequence):
        return f"seq[{','.join(_comptime_repr(x) for x in v)}]"
    if isinstance(v, ElemType):
        return f"ty:{v.name}"
    if isinstance(v, type):
        return f"cls:{v.__qualname__}"
    return repr(v)


def cube(fn=None, /, **options):
    """``@cube`` / ``@cube(launch=True, fast_math=..., debug_symbols=...)``.

    Options mirror the reference macro options (cubecl-macros/src/parse/
    kernel.rs:23-40); ``launch``/``launch_unchecked`` flags exist for API
    parity but launch methods are always generated.
    """
    if fn is not None:
        return CubeFunction(fn)

    def wrap(f):
        return CubeFunction(f, **options)

    return wrap
