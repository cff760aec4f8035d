"""``python -m pint_tpu_torch.pintk PARFILE TIMFILE``."""

import sys

from pint_tpu_torch.pintk import main

sys.exit(main())
