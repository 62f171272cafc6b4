"""Build the native runtime: python -m soundscope_tpu_torch.native.build [CXX]"""

import sys

from soundscope_tpu_torch.native import build

if __name__ == "__main__":
    print(build(force=True, cxx=sys.argv[1] if len(sys.argv) > 1 else None))
