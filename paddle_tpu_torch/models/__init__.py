"""Model builders."""
from . import mnist, resnet, transformer  # noqa: F401
