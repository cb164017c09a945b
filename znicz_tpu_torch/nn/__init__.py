"""Neural-network units (port of ``znicz_tpu/nn``): the forward and
gradient units of the fc, conv, pooling, LRN, dropout, standalone
activation, depooling and deconv layers, the softmax and MSE evaluators,
the decisions, and the Kohonen SOM units; stochastic pooling and the
cutter units are ROADMAP.md queue 1 item 5a."""
