"""Model builders."""
from . import deepfm, mnist, nmt, resnet, transformer, vision  # noqa: F401
