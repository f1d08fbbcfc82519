"""One driver a kind of traffic: serve, train."""
