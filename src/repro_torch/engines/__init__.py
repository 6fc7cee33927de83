"""The port's engines: the shared runtime and pipeline state, and the
device-resident superstep engine (``hype_superstep``)."""
