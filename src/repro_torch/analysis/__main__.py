import sys

from repro_torch.analysis.cli import main

sys.exit(main())
