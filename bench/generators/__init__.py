"""One file a graph generator, found by a configuration's
``"generator"``: ``make(cfg, gen, device)`` draws the graph on the device
with the ``torch.Generator`` ``gen`` and returns a ``graphs.Graph``."""
