"""Model builders."""
from . import deepfm, mnist, nmt, resnet, transformer  # noqa: F401
