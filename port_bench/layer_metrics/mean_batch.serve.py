"""The mean batch of the server's dispatches in the window: the entries
``SortServer.stats["batch_sizes"]`` gained between the window's start
and its end (instances a dispatch carried)."""


def read(inputs):
    sizes = inputs.get("batch_sizes")
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
