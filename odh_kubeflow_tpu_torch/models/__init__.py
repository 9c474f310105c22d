from odh_kubeflow_tpu_torch.models.generate import (  # noqa: F401
    GenerateConfig,
    generate,
    init_cache,
    sample_logits,
)
from odh_kubeflow_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    forward,
    forward_with_cache,
    init_params,
)
from odh_kubeflow_tpu_torch.models.moe import MoeConfig  # noqa: F401
from odh_kubeflow_tpu_torch.models.lora import (  # noqa: F401
    LoraConfig,
    init_lora_params,
    merge_lora,
)
