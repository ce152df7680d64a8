/* Plain-C client for the band-tpu-torch HTTP serving tier (server.py
 * and router.py speak the same JSON protocol as band_tpu's) — the
 * non-Python client proof for the network serving surface.  The gRPC
 * tier's non-Python path is protoc codegen from band_grpc.proto.
 *
 * Usage: http_client <host> <port> <model.tflite> <input.bin> <dtype>
 *                    <d0,d1,...> <output.bin>
 *   1. GET  /health            -> expects "ok"
 *   2. POST /models            -> registers the model, parses model_id
 *   3. POST /request           -> input.bin's bytes as a <dtype> tensor
 *                                 of the given dims; the first output
 *                                 tensor's bytes go to output.bin
 *
 * Build: gcc -O2 -o http_client http_client_main.c
 */

#include <arpa/inet.h>
#include <netdb.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

static const char B64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

static char *b64_encode(const unsigned char *in, size_t n) {
  size_t out_len = 4 * ((n + 2) / 3);
  char *out = malloc(out_len + 1);
  size_t i, j = 0;
  for (i = 0; i + 2 < n; i += 3) {
    unsigned v = (in[i] << 16) | (in[i + 1] << 8) | in[i + 2];
    out[j++] = B64[(v >> 18) & 63];
    out[j++] = B64[(v >> 12) & 63];
    out[j++] = B64[(v >> 6) & 63];
    out[j++] = B64[v & 63];
  }
  if (i < n) {
    unsigned v = in[i] << 16;
    int two = (i + 1 < n);
    if (two) v |= in[i + 1] << 8;
    out[j++] = B64[(v >> 18) & 63];
    out[j++] = B64[(v >> 12) & 63];
    out[j++] = two ? B64[(v >> 6) & 63] : '=';
    out[j++] = '=';
  }
  out[j] = 0;
  return out;
}

static int b64_val(char c) {
  const char *p = strchr(B64, c);
  return (p && c) ? (int)(p - B64) : -1;
}

static size_t b64_decode(const char *in, unsigned char *out) {
  size_t j = 0;
  int acc = 0, bits = 0;
  for (; *in && *in != '"' && *in != '='; ++in) {
    int v = b64_val(*in);
    if (v < 0) continue;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[j++] = (unsigned char)((acc >> bits) & 0xff);
    }
  }
  return j;
}

static int http_post(const char *host, int port, const char *path,
                     const char *body, char *resp, size_t resp_cap) {
  struct hostent *he = gethostbyname(host);
  if (!he) return -1;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct sockaddr_in addr = {0};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((unsigned short)port);
  memcpy(&addr.sin_addr, he->h_addr_list[0], he->h_length);
  if (connect(fd, (struct sockaddr *)&addr, sizeof addr) < 0) {
    close(fd);
    return -1;
  }
  char header[512];
  int method_get = (body == NULL);
  int n = snprintf(header, sizeof header,
                   "%s %s HTTP/1.1\r\nHost: %s\r\n"
                   "Content-Type: application/json\r\n"
                   "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                   method_get ? "GET" : "POST", path, host,
                   body ? strlen(body) : 0);
  if (write(fd, header, n) != n) { close(fd); return -1; }
  if (body && write(fd, body, strlen(body)) != (ssize_t)strlen(body)) {
    close(fd);
    return -1;
  }
  size_t got = 0;
  ssize_t r;
  while ((r = read(fd, resp + got, resp_cap - 1 - got)) > 0) got += r;
  resp[got] = 0;
  close(fd);
  /* parse status */
  int status = 0;
  sscanf(resp, "HTTP/%*s %d", &status);
  return status;
}

static unsigned char *read_all(const char *path, size_t *n) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  unsigned char *data = malloc(size > 0 ? (size_t)size : 1);
  *n = fread(data, 1, (size_t)size, f);
  fclose(f);
  return data;
}

int main(int argc, char **argv) {
  if (argc != 8) {
    fprintf(stderr,
            "usage: %s <host> <port> <model.tflite> <input.bin> <dtype> "
            "<d0,d1,...> <output.bin>\n",
            argv[0]);
    return 2;
  }
  const char *host = argv[1];
  int port = atoi(argv[2]);
  static char resp[1 << 24];

  /* 1. health */
  if (http_post(host, port, "/health", NULL, resp, sizeof resp) != 200 ||
      !strstr(resp, "ok")) {
    fprintf(stderr, "health check failed:\n%s\n", resp);
    return 1;
  }
  printf("health: ok\n");

  /* 2. register */
  char body[4096];
  snprintf(body, sizeof body, "{\"path\": \"%s\"}", argv[3]);
  if (http_post(host, port, "/models", body, resp, sizeof resp) != 200) {
    fprintf(stderr, "register failed:\n%s\n", resp);
    return 1;
  }
  const char *mid_s = strstr(resp, "\"model_id\":");
  if (!mid_s) { fprintf(stderr, "no model_id in:\n%s\n", resp); return 1; }
  int model_id = atoi(mid_s + strlen("\"model_id\":"));
  printf("model_id: %d\n", model_id);

  /* 3. request: the input file's bytes as one tensor */
  size_t n_in = 0;
  unsigned char *input = read_all(argv[4], &n_in);
  if (!input) { fprintf(stderr, "cannot read %s\n", argv[4]); return 1; }
  char *b64 = b64_encode(input, n_in);
  char *req = malloc(strlen(b64) + 1024);
  sprintf(req,
          "{\"model_id\": %d, \"sync\": true, \"inputs\": [{\"shape\": "
          "[%s], \"dtype\": \"%s\", \"b64\": \"%s\"}]}",
          model_id, argv[6], argv[5], b64);
  int status = http_post(host, port, "/request", req, resp, sizeof resp);
  free(req);
  free(b64);
  free(input);
  if (status != 200) {
    fprintf(stderr, "request failed (%d):\n%s\n", status, resp);
    return 1;
  }
  const char *out_b64 = strstr(resp, "\"b64\": \"");
  if (!out_b64) out_b64 = strstr(resp, "\"b64\":\"");
  if (!out_b64) { fprintf(stderr, "no output tensor:\n%s\n", resp); return 1; }
  out_b64 = strchr(out_b64 + 6, '"') + 1;
  static unsigned char raw[1 << 23];
  size_t nb = b64_decode(out_b64, raw);
  FILE *f = fopen(argv[7], "wb");
  if (!f || fwrite(raw, 1, nb, f) != nb || fclose(f) != 0) {
    fprintf(stderr, "cannot write %s\n", argv[7]);
    return 1;
  }
  printf("request: %zu output bytes written\nC HTTP CLIENT OK\n", nb);
  return 0;
}
