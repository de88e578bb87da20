"""The plain PyTorch reference that the program's outputs are compared with:
frozen copies of the plain versions of the rasterizer and the guidance
modules, and one training step written out plainly. It imports nothing of
the program (`dreamscene_tpu_torch`), of JAX or of the JAX package."""
