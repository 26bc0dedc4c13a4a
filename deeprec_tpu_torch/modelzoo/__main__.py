"""`python -m deeprec_tpu_torch.modelzoo --model <name> [flags]`: train one
modelzoo model on the port (see `common.py`)."""
from deeprec_tpu_torch.modelzoo.common import main

if __name__ == "__main__":
    main()
