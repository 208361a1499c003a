"""Reconstruction ops: golden numpy oracles + jittable JAX versions.

Every op ships in two forms:
  * golden_*  — numpy, scalar-faithful to the reference's arithmetic
                (including f32 accumulation order); the parity oracle.
  * *_jnp     — jittable jnp implementation, bit-exact to golden.
"""
