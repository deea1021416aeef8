"""Models of the port: counterparts of picha_tpu/models/ modules (the ViT
and the ResNet, their train steps, and the checkpoint)."""
from .resnet import ResNet, ResNetConfig
from .vit import ViT, ViTConfig

__all__ = ["ResNet", "ResNetConfig", "ViT", "ViTConfig"]
