"""The TBN model of the port: towers, attention, heads, the weight bridge."""
