"""cubecl_tpu_torch.std — the standard library layer (counterpart of
``cubecl_tpu.std``, exporting its names; reference crate: cubecl-std):
layouts, views and index math (host-side, copied), ``into_contiguous`` and
``identity`` on K0, ``reinterpret_slice`` and the other helpers of
``misc``, the quantization schemes and their K0 kernels, and the peak
runners of ``ThroughputCache``, which measure the card."""

from .contiguous import TensorHandle, identity, into_contiguous
from .fastmath import FastDivmod
from .layout import (
    ChainLayout,
    Layout,
    LinearLayout,
    PermutedLayout,
    SliceLayout,
    StridedLayout,
    TiledLayout,
)
from .quant import (
    QuantLevel,
    QuantMode,
    QuantParam,
    QuantScheme,
    dequantize_np,
    quantize_np,
)
from .misc import (
    EventBus,
    GLOBAL_EVENTS,
    MatrixBatchLayout,
    matrix_batch_layout,
    reinterpret_slice,
    sin_cos,
    swizzle_2d,
    swizzle_xor,
)
from .throughput import ThroughputCache
from .view import View, ViewMut, VirtualTensor
from .zspace import (
    broadcast_shapes,
    contiguous_strides,
    delinearize,
    is_contiguous,
    linear_index,
    num_elements,
    permuted_strides,
    validate_strides,
)
