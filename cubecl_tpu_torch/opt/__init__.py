"""cubecl_tpu_torch.opt — IR analyses + scope passes (reference crates:
cubecl-opt and cubecl-core/src/post_processing)."""

from .analysis import Affine, UniformityAnalysis
from .checked_io import insert_checked_io
from .passes import const_fold, dead_code, fold_builtins, optimize_scope
from .processors import FastMathProcessor, Processor, run_processors
