"""Minibatch loaders (port of ``znicz_tpu/loader``): the resident
full-batch loaders, the ``.znr`` record shards, the streaming loaders with
their host-to-card prefetcher, and the crop-and-mirror augmentation."""

from .augment import RandomCropFlip
from .base import TEST, TRAIN, VALID, Loader
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE
from .records import RecordFile, RecordWriter, write_records
from .streaming import (BatchPrefetcher, OnTheFlyImageLoader,
                        RecordLoader, StagingRing, StreamingLoader)

__all__ = ["TEST", "TRAIN", "VALID", "Loader", "FullBatchLoader",
           "FullBatchLoaderMSE", "RecordFile", "RecordWriter",
           "write_records", "BatchPrefetcher", "OnTheFlyImageLoader",
           "RecordLoader", "StagingRing", "StreamingLoader",
           "RandomCropFlip"]
