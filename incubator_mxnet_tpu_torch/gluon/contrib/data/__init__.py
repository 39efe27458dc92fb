"""gluon.contrib.data (`incubator_mxnet_tpu/gluon/contrib/data/`)."""
from .sampler import IntervalSampler  # noqa: F401
from .text import WikiText2, WikiText103  # noqa: F401
