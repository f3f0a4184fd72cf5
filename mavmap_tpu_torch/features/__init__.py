"""Feature detection, description, caching, and providers."""

from .provider import Features, FeatureProvider, ArrayFeatureProvider  # noqa: F401
from .cache import (FeatureCache, ReferenceCacheProvider,  # noqa: F401
                    read_reference_features)
