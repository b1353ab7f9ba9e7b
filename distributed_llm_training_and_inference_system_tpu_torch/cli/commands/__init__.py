"""One module a command: ``build_parser(prog)`` and ``run(args)``."""
