"""The program's host syncs per MMA iteration of the traced slice: its
``bdd.sync`` spans among the slice's host events, each a read of the card's
values on the host or a copy that waits for the card's stream. None where the
slice holds no span of the program (``bdd.*``), as in a program without them."""


def read(summary):
    names = [name for name, _, _ in summary["host"]]
    if not any(name.startswith("bdd.") for name in names):
        return None
    return names.count("bdd.sync") / summary["iterations"]
