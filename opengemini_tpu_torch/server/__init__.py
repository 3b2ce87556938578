"""HTTP protocol front-end (/ping, /write, /query)."""
