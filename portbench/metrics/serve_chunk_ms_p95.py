"""95th percentile of a request's ms, taking its volumes to its stitched outputs synchronised."""

from portbench import readers

read = readers.item_ms_quantile("serve", 95)
