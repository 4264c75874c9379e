"""Models of the port: the Llama-3 family (``llama.py``), the weight
bridge from the JAX package (``params.py``), KV-cache generation
(``generate.py``) and the HTTP server (``serving.py``)."""
