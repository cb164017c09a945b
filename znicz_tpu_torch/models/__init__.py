"""Runnable samples (port of ``znicz_tpu/models``): MNIST so far."""
