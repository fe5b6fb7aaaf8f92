"""Online serving: continuous micro-batching, one dispatch thread, the
precision overlay, and the HTTP front end."""
