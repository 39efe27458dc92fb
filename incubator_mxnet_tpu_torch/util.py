"""Small utilities (`incubator_mxnet_tpu/util.py`)."""


def is_np_array():
    """The numpy-array semantics switch of the reference: always off."""
    return False
