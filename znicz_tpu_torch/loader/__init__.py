"""Minibatch loaders (port of ``znicz_tpu/loader``): resident full-batch
loaders only; streaming, records and augmentation are ROADMAP.md queue 1
item 8."""
