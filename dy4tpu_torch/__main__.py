import sys

from dy4tpu_torch.app import main

sys.exit(main())
