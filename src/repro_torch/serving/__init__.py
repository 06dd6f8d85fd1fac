"""serving of the PyTorch port."""

from .engine import Engine, EngineStats, PagePool, Request, RequestStats
from .faults import Fault, FaultPlan
from .sampler import SamplerConfig, sample, sample_per_slot
