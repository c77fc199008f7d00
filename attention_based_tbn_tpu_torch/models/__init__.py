"""The TBN model of the port: towers, attention, heads, the weight bridge,
and the conversions to and from the reference and the JAX package."""
