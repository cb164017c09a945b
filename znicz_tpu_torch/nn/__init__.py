"""Neural-network units (port of ``znicz_tpu/nn``): the forward and
gradient units of the fc, conv, pooling (max, max-abs, average and
stochastic), LRN, dropout, standalone activation, depooling and deconv
layers, the cutter and the mergers, the softmax and MSE evaluators, the
decisions, the Kohonen SOM units and the RBM units."""
