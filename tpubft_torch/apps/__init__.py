"""Demo applications / test state machines (reference tests/simpleTest,
tests/simpleKVBC, examples/)."""
