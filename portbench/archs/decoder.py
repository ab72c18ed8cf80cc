"""The decoder: a pre-norm MHA (or GQA) block with a SiLU-gated FFN, or an
MoE after ``first_k_dense_replace`` dense layers whose experts a softmax
router picks; tied or untied head.  It reads every configuration file
without an ``"arch"`` key (`arch` lists what an architecture provides).

Its code is where it was before architectures were modules: the numbers
in `arch.read_decoder`, the leaves in `weights.kinds`, the port's model in
`port.model_config` and `port.param_name`, the counts in `counts`, the
reference in `reference.decoder`.  Its global kinds are here.
"""

from ..arch import read_decoder as from_dict  # noqa: F401
from ..counts import decode_bytes, decode_flops, prefill_flops, train_flops  # noqa: F401
from ..port import model_config, param_name  # noqa: F401
from ..weights import kinds  # noqa: F401

GLOBAL = ("tok", "final_norm", "unembed")
