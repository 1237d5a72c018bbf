"""marian-server entry point of the port (reference:
src/command/marian_server.cpp): iteration-level greedy serving over a
paged KV pool, on the length-prefixed TCP framing. Runs on the card;
``--cpu-threads N`` runs on the CPU instead.

    python -m marian_tpu_torch.cli.marian_server --models model.npz \\
        --vocabs v.yml v.yml --batching-mode iteration --beam-size 1 \\
        --port 8080

SIGTERM/SIGINT drain the queue before exiting.
"""


def main(argv=None):
    from ..common.config_parser import parse_options
    opts = parse_options(argv, mode="server")
    from ..server.server import serve_main
    serve_main(opts)


if __name__ == "__main__":
    main()
