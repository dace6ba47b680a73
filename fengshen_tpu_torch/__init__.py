"""fengshen_tpu_torch: the PyTorch + CUDA port of ``fengshen_tpu``.

The port lives beside the JAX package, which stays the reference it is
held against (``tests/test_torch_*.py`` feed both the same inputs). It
keeps the JAX package's module layout and names; inside, modules are
``torch.nn.Module``s and plain tensor functions, and every TPU kernel on
a ported path is a kernel written by hand for Hopper
(``fengshen_tpu_torch/csrc``, bound in ``ops/kernels``).

This package imports ``torch`` and never ``jax``, ``flax`` or anything of
``fengshen_tpu``: where it needs a JAX-free module of the reference, it
keeps its own copy.

Entry points (``LlamaForCausalLM``, ``utils.generate.generate``,
``serving.ContinuousBatchingEngine``, ``pipelines.text_generation.Pipeline``,
``api.main``) run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`fengshen_tpu_torch.device`).
"""

from fengshen_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
