"""Models of the port: the JAX package's model zoo (``horovod_tpu/models``)
in PyTorch, each with ``params_from_jax`` to carry the JAX package's
weights across."""

from . import transformer  # noqa: F401
from .inception import InceptionV3  # noqa: F401
from .inception import params_from_jax as inception_params_from_jax  # noqa: F401
from .mlp import MLP, MnistConvNet  # noqa: F401
from .mlp import mlp_params_from_jax  # noqa: F401
from .mlp import params_from_jax as mnist_params_from_jax  # noqa: F401
from .resnet import ResNet, ResNet50, ResNet101, ResNet152  # noqa: F401
from .resnet import params_from_jax as resnet_params_from_jax  # noqa: F401
from .vgg import VGG, VGG16, VGG19  # noqa: F401
from .vgg import params_from_jax as vgg_params_from_jax  # noqa: F401
from .vit import ViT, ViT_B16, ViT_L16, ViT_S16  # noqa: F401
from .vit import params_from_jax as vit_params_from_jax  # noqa: F401
