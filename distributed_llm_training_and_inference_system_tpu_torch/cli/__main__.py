"""``python -m distributed_llm_training_and_inference_system_tpu_torch.cli``
runs ``llmctl-torch``."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
