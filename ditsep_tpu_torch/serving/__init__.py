"""Serving: dynamic-batching separation over the port's samplers (port of
ditsep_tpu/serving).

``BatchingEngine`` queues requests on the host; a dispatch thread groups
them into bounded (bucket_length, batch_size) shapes (the eval harness's
frame-block buckets, so padding never changes an utterance's quiet
fraction, docs/pad_dilution_r03.md) and runs each group as one sampler
call on the card. ``SeparationAPIServer`` exposes it over a
dependency-free HTTP JSON/WAV API, and ``StreamingSeparator`` separates
live streams in bounded-latency windows, alone or through a shared engine
(``engine_separate_fn``).
"""
from ditsep_tpu_torch.serving.engine import (  # noqa: F401
    BatchingEngine, frame_block_padded_len,
)
from ditsep_tpu_torch.serving.api import SeparationAPIServer  # noqa: F401
from ditsep_tpu_torch.serving.streaming import (  # noqa: F401
    StreamingSeparator, engine_separate_fn,
)

__all__ = ["BatchingEngine", "SeparationAPIServer",
           "StreamingSeparator", "engine_separate_fn",
           "frame_block_padded_len"]
