"""``python -m distribuuuu_tpu_torch.serve --cfg config/serve_resnet50.yaml ...``"""

import sys

from distribuuuu_tpu_torch.serve.frontend import serve_main

if __name__ == "__main__":
    sys.exit(serve_main())
