"""Functional math on torch tensors (port of ``znicz_tpu/ops``): each op's
plain PyTorch version beside the wrapper of its hand-written kernel."""
