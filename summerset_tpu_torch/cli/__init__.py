"""Executable entry points of the port, counterpart of ``summerset_tpu/cli``:

    python -m summerset_tpu_torch.cli.manager -p MultiPaxos -n 3 ...
    python -m summerset_tpu_torch.cli.server  -p MultiPaxos -a ... -i ...
    python -m summerset_tpu_torch.cli.proxy   -m 127.0.0.1:52600 -a 52900

The server runs on the card unless ``--device cpu`` is given; the
ingress proxy never touches the card.
"""
