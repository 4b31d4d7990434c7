"""Dense transformer of the port: primitives, attention, model assembly."""
