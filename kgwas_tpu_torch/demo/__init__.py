"""The five demos, counterparts of the JAX package's ``demo/`` mirrors of
the reference's notebooks; each runs as
``python -m kgwas_tpu_torch.demo.<name>`` or through ``main(argv)``."""
