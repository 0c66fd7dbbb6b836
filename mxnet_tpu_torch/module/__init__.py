"""``mx.mod``: the Module API (``Module``, ``BucketingModule``,
``SequentialModule``)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
