"""Sequential structure-from-motion engine."""

from .options import SequentialMapperOptions  # noqa: F401
from .mapper import SequentialMapper  # noqa: F401
