"""Model builders."""
from . import deepfm, mnist, resnet, transformer  # noqa: F401
