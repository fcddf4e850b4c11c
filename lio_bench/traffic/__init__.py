"""The benchmark's traffic: a course, a world and one general renderer."""
