"""Feature providers."""

from .provider import Features, FeatureProvider, ArrayFeatureProvider  # noqa: F401
