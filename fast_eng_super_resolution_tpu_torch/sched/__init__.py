from .classifiers import classifier_from_jax, init_classifier
from .encoders import encoder_from_jax, init_encoder
from .scheduler import PartitionScheduler

__all__ = ["init_classifier", "init_encoder", "PartitionScheduler",
           "routing_from_jax"]


def routing_from_jax(encoder, classifier):
    """(encoder, classifier) of the port carrying a JAX-package encoder's
    and classifier's fitted state (numpy arrays; the VAE's parameter tree),
    so that both packages route the same subdomains to the same experts."""
    return encoder_from_jax(encoder), classifier_from_jax(classifier)
