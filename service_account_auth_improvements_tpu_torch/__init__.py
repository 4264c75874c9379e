"""PyTorch/CUDA port of the in-notebook Llama workload.

The JAX package ``service_account_auth_improvements_tpu`` is the reference;
this package mirrors its module names (``ops/``, ``models/``, ``utils/``) so
each port module's counterpart is easy to find. It imports ``torch``, numpy
and the stdlib only — never ``jax`` and nothing of the JAX package.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without CUDA and without that request they raise
(``utils/device.py``). The Pallas kernels of the reference become
hand-written Hopper kernels under ``csrc/``, built at first use
(``ops/_build.py``).
"""
