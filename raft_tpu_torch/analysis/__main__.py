"""Entry point: ``python -m raft_tpu_torch.analysis [paths...]``.

The ``__name__`` guard matters: tooling that walks packages imports this
module as ``raft_tpu_torch.analysis.__main__``, which must not run the
CLI.
"""

import sys

from raft_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
