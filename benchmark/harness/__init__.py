"""The benchmark's machinery: the spec, the inputs made from the seed,
the reading of the device trace and the comparisons that decide
`correct`."""
