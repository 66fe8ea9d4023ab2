"""Utility subpackage: device choice and the weight bridge from the JAX
package."""
