"""Runnable samples (port of ``znicz_tpu/models``): MNIST, CIFAR-10 and
AlexNet."""
