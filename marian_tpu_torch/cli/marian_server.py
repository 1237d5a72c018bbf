"""marian-server entry point of the port (reference:
src/command/marian_server.cpp). Serves the Marian WebSocket protocol
where the ``websockets`` package is installed, else the dependency-free
length-prefixed TCP framing (``MTPU <nbytes>\\n`` + payload): request
mode by default (token-budget batches through the beam search), or
iteration mode over a paged KV pool (greedy at ``--beam-size 1``, the
copy-on-write beam engine above it), with the brownout ladder
(``--brownout``) and multi-tenant fleet serving (``--fleet``, request
mode). Runs on the card; ``--cpu-threads N`` runs on the CPU instead.

    python -m marian_tpu_torch.cli.marian_server --models model.npz \\
        --vocabs v.yml v.yml --port 8080
    python -m marian_tpu_torch.cli.marian_server --models model.npz \\
        --vocabs v.yml v.yml --batching-mode iteration --beam-size 1 \\
        --brownout --port 8080
    python -m marian_tpu_torch.cli.marian_server --vocabs v.yml v.yml \\
        --fleet a=a.npz,b=b.npz --fleet-default-tenant a \\
        --fleet-hbm-budget-mb 4096 --port 8080

SIGTERM/SIGINT drain the queue before exiting.
"""


def main(argv=None):
    from ..common.config_parser import parse_options
    opts = parse_options(argv, mode="server")
    from ..server.server import serve_main
    serve_main(opts)


if __name__ == "__main__":
    main()
