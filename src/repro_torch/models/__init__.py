"""Model stack (port of the reference ``models``): dense GQA transformers
with the flash-attention kernel as the prefill attention core."""
from repro_torch.models.transformer import (  # noqa: F401
    backbone,
    decode_step,
    init_cache,
    model_p,
    prefill,
    segments,
)
from repro_torch.models.module import (  # noqa: F401
    materialize,
    param_count,
    params_from_numpy,
)
