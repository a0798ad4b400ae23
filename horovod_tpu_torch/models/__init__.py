"""Models of the port."""

from .resnet import ResNet, ResNet50, ResNet101, ResNet152  # noqa: F401
from .resnet import params_from_jax as resnet_params_from_jax  # noqa: F401
