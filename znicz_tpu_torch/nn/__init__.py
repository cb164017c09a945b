"""Neural-network units (port of ``znicz_tpu/nn``): the fc forward and
gradient units, the softmax evaluator and the decision units; the conv,
pooling, normalization and dropout units are ROADMAP.md queue 1 item 5."""
