"""Loop detection: vocabulary tree + TF-IDF image retrieval."""

from .voctree import VocTree, train_voc_tree  # noqa: F401
from .detector import LoopDetector  # noqa: F401
