"""Trainer twins of the JAX package's `examples/`, runnable as modules
(``python -m gammagl_tpu_torch.examples.<name>``)."""
