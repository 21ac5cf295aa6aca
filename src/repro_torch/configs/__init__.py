"""Model configs the port serves (copies of ``repro.configs`` entries).

Importing this package registers every config; select with
``repro_torch.models.config.get_config(name)`` or ``--arch <id>``.
"""

from repro_torch.configs import (deepseek_67b,  # noqa: F401
                                 deepseek_v2_lite_16b, hubert_xlarge,
                                 internvl2_1b, mamba2_780m, minicpm_2b,
                                 pam_llama_7b, qwen3_0_6b, qwen3_14b,
                                 qwen3_moe_235b_a22b, zamba2_7b)
