"""Model bundles and weights carried across from the JAX package."""
