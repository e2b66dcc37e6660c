import sys

from fm_spark_tpu_torch.cli import main

sys.exit(main())
