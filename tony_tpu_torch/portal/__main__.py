import sys

from tony_tpu_torch.portal.server import main

if __name__ == "__main__":
    sys.exit(main())
