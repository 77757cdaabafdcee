"""Symbolic model builders: ``models.resnet(num_layers=50, ...)``, the
reference-style ``models.resnet_symbol(..., image_shape="3,224,224")``,
and the GPT language model ``models.gpt_lm(vocab, dim, heads, layers,
seq_len)``."""
from .gpt import gpt_lm, make_copy_batch  # noqa: F401
from .resnet import get_symbol as resnet_symbol  # noqa: F401
from .resnet import resnet  # noqa: F401
