"""Streamed advisory tables (graftstream, parallel/stream.py): the
JAX package's parallel/ names the port serves so far."""

from .stream import (SliceCache, SlicePlan, StreamingDetector,
                     StreamOptions, clip_descriptors, hbm_budget_bytes,
                     merge_slice_bits, plan_slices, slice_bounds,
                     touched_slices)

__all__ = ["SliceCache", "SlicePlan", "StreamingDetector", "StreamOptions",
           "clip_descriptors", "hbm_budget_bytes", "merge_slice_bits",
           "plan_slices", "slice_bounds", "touched_slices"]
