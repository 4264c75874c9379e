"""Models of the port: the Llama-3 family (``llama.py``), the weight
bridge from the JAX package (``params.py``), KV-cache generation
(``generate.py``), the HTTP server (``serving.py``), int8 weights
(``quantize.py``), speculative decoding (``speculative.py``), Hugging Face
checkpoint conversion both ways (``convert_hf.py``), and the side models:
ResNet (``resnet.py``, BASELINE.json configuration #3) and the MNIST MLP
(``mnist.py``, configurations #1 and #2)."""

from service_account_auth_improvements_tpu_torch.models import (  # noqa: F401
    convert_hf,
    generate,
    llama,
    mnist,
    quantize,
    resnet,
)
