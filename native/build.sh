#!/bin/sh
# Build the native golden scanner shared library for this machine.
# Usage: build.sh [OUTPUT]   (default: libgolden_scan.so beside this script)
set -e
cd "$(dirname "$0")"
out="${1:-libgolden_scan.so}"
g++ -O3 -march=native -shared -fPIC -o "$out" golden_scan.cpp
echo "built $out"
