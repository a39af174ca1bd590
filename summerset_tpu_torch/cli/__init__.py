"""Executable entry points of the port, counterpart of ``summerset_tpu/cli``:

    python -m summerset_tpu_torch.cli.manager -p MultiPaxos -n 3 ...
    python -m summerset_tpu_torch.cli.server  -p MultiPaxos -a ... -i ...

The server runs on the card unless ``--device cpu`` is given.
"""
