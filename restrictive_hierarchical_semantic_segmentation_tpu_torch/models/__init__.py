from .film import FiLM  # noqa: F401
from .hierarchical import HierarchicalSegmenter, SegmenterOutput, build_model  # noqa: F401
from .backbones.hrnet import HRNetBackbone  # noqa: F401
from .backbones.unet import UNetBackbone  # noqa: F401
from .norm import BatchNormAct  # noqa: F401
