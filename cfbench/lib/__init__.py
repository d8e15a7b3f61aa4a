"""The harness: spec loading, data, generators, trace reduction, counts and peaks."""
