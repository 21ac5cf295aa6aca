"""Model configs the port serves (copies of ``repro.configs`` entries).

Importing this package registers every config; select with
``repro_torch.models.config.get_config(name)`` or ``--arch <id>``.
"""

from repro_torch.configs import pam_llama_7b, qwen3_0_6b  # noqa: F401
