"""The port's copy of the JAX package's BSK-form decision (``v0``)."""
