"""Core: K-quant formats, the paper's dynamic policies (DQ3_K_M), PTQ, and
the size calculator."""

from .formats import FORMATS
from .policy import POLICIES, Policy, get_policy
from .qtensor import QTensor, quantize
from .apply import format_map, init_quantized_params, quantize_params
from .size import SizeReport, kv_cache_bytes, model_size, serving_memory

__all__ = ["FORMATS", "POLICIES", "Policy", "get_policy", "QTensor",
           "quantize", "format_map", "init_quantized_params",
           "quantize_params", "SizeReport", "model_size", "kv_cache_bytes",
           "serving_memory"]
