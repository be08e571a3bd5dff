/* A columnar reader of one host's NVLink snapshot DB, for the fleet loader
 * (gpud_tpu_torch/snapshot_reader.py wraps it with ctypes).
 *
 * tpud_open opens the DB read-only through a URI, as Python's sqlite3 does
 * (busy timeout 5,000 ms), and reads the tombstone table. tpud_window runs
 * the window's query and steps its rows straight into four columns: link id
 * (the order first fetched), ts, state and CRC. A value it does not convert
 * itself (a NULL, TEXT or BLOB number, a REAL state or CRC, a state outside
 * int8) stops the walk with TPUD_VALUE; the caller converts it, and
 * tpud_resume stores the result and walks on. At the end the DB is closed;
 * the columns and the link names live until tpud_close.
 *
 * SQLite's header is not needed: the few functions used are declared here,
 * and the library is the one the interpreter's sqlite3 module loaded.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;

int sqlite3_open_v2(const char *filename, sqlite3 **db, int flags, const char *vfs);
int sqlite3_busy_timeout(sqlite3 *db, int ms);
int sqlite3_close_v2(sqlite3 *db);
int sqlite3_extended_errcode(sqlite3 *db);
const char *sqlite3_errmsg(sqlite3 *db);
int sqlite3_prepare_v2(sqlite3 *db, const char *sql, int n, sqlite3_stmt **stmt, const char **tail);
int sqlite3_bind_double(sqlite3_stmt *stmt, int i, double v);
int sqlite3_step(sqlite3_stmt *stmt);
int sqlite3_finalize(sqlite3_stmt *stmt);
int sqlite3_column_type(sqlite3_stmt *stmt, int i);
int64_t sqlite3_column_int64(sqlite3_stmt *stmt, int i);
double sqlite3_column_double(sqlite3_stmt *stmt, int i);
const void *sqlite3_column_blob(sqlite3_stmt *stmt, int i);
const unsigned char *sqlite3_column_text(sqlite3_stmt *stmt, int i);
int sqlite3_column_bytes(sqlite3_stmt *stmt, int i);

#define SQLITE_OK 0
#define SQLITE_NOMEM 7
#define SQLITE_ROW 100
#define SQLITE_DONE 101
#define SQLITE_INTEGER 1
#define SQLITE_FLOAT 2
#define SQLITE_TEXT 3
#define SQLITE_BLOB 4
#define SQLITE_NULL 5
#define SQLITE_OPEN_READONLY 0x00000001
#define SQLITE_OPEN_URI 0x00000040
#define SQLITE_OPEN_NOMUTEX 0x00008000

#define TPUD_VALUE 1000 /* a value for the caller to convert */
#define BUSY_TIMEOUT_MS 5000 /* Python's sqlite3.connect(timeout=5.0) */

/* One value as SQLite typed it; TEXT and BLOB bytes at p, n long. */
typedef struct {
    int64_t type;
    int64_t i;
    double f;
    const char *p;
    int64_t n;
} tpud_value;

typedef struct {
    /* read by the caller (the ctypes Structure mirrors these fields) */
    int64_t errcode;        /* SQLite's extended code of the last failure */
    char *errmsg;           /* and its message */
    int64_t tomb_rc;        /* the tombstone read's result: 0 or a failure */
    int64_t n_tombstones;
    tpud_value *tombstones; /* link, ts of each row */
    int64_t n_rows;
    int32_t *lid;
    double *ts;
    int8_t *state;
    int64_t *crc;
    int64_t n_links;
    char *names;            /* the TEXT names by id, end to end: link k's */
    int64_t *name_ends;     /* end at name_ends[k], its start the end before */
    int64_t bad_col;        /* the column of the value to convert */
    tpud_value bad;
    /* private */
    sqlite3 *db;
    sqlite3_stmt *stmt;
    int64_t cap;
    int64_t *slots;         /* open addressing: link id + 1, 0 empty */
    int64_t n_slots;
    int64_t names_cap;
    int64_t ends_cap;
} tpud_reader;

static char *copy_bytes(const void *p, int64_t n) {
    char *out = malloc(n + 1);
    if (out) {
        if (n) memcpy(out, p, n);
        out[n] = 0;
    }
    return out;
}

/* Keeps SQLite's code and message of a failure; returns its primary code. */
static int fail(tpud_reader *h, int rc) {
    const char *msg = h->db ? sqlite3_errmsg(h->db) : "out of memory";
    h->errcode = h->db ? sqlite3_extended_errcode(h->db) : rc;
    free(h->errmsg);
    h->errmsg = copy_bytes(msg, strlen(msg));
    return rc & 0xff;
}

/* The column's value; TEXT and BLOB bytes stay SQLite's until the next step. */
static tpud_value column_value(sqlite3_stmt *st, int c) {
    tpud_value v = {sqlite3_column_type(st, c), 0, 0.0, NULL, 0};
    if (v.type == SQLITE_INTEGER) {
        v.i = sqlite3_column_int64(st, c);
    } else if (v.type == SQLITE_FLOAT) {
        v.f = sqlite3_column_double(st, c);
    } else if (v.type == SQLITE_TEXT || v.type == SQLITE_BLOB) {
        v.p = v.type == SQLITE_TEXT ? (const char *)sqlite3_column_text(st, c)
                                    : (const char *)sqlite3_column_blob(st, c);
        v.n = sqlite3_column_bytes(st, c);
    }
    return v;
}

static void finish(tpud_reader *h) {
    if (h->stmt) sqlite3_finalize(h->stmt);
    h->stmt = NULL;
    if (h->db) sqlite3_close_v2(h->db);
    h->db = NULL;
}

static void free_values(tpud_value *v, int64_t n) {
    for (int64_t k = 0; k < n; k++) free((void *)v[k].p);
    free(v);
}

static int read_tombstones(tpud_reader *h, const char *sql) {
    int64_t cap = 0;
    int rc = sqlite3_prepare_v2(h->db, sql, -1, &h->stmt, NULL);
    while (rc == SQLITE_OK) {
        if ((rc = sqlite3_step(h->stmt)) != SQLITE_ROW) break;
        rc = SQLITE_OK;
        if (h->n_tombstones == cap) {
            cap = cap ? 2 * cap : 16;
            tpud_value *t = realloc(h->tombstones, 2 * cap * sizeof *t);
            if (!t) return SQLITE_NOMEM;
            h->tombstones = t;
        }
        tpud_value *row = &h->tombstones[2 * h->n_tombstones++];
        row[0].p = row[1].p = NULL; /* what tpud_close frees, if a copy fails */
        for (int c = 0; c < 2; c++) {
            tpud_value v = column_value(h->stmt, c);
            if (v.p && !(v.p = copy_bytes(v.p, v.n))) return SQLITE_NOMEM;
            row[c] = v;
        }
    }
    sqlite3_finalize(h->stmt);
    h->stmt = NULL;
    return rc == SQLITE_DONE ? SQLITE_OK : fail(h, rc);
}

int tpud_open(const char *uri, const char *tombstone_sql, tpud_reader **out) {
    tpud_reader *h = calloc(1, sizeof *h);
    *out = h;
    if (!h) return SQLITE_NOMEM;
    /* one thread uses the connection: no mutex on each column read */
    int rc = sqlite3_open_v2(uri, &h->db,
                             SQLITE_OPEN_READONLY | SQLITE_OPEN_URI | SQLITE_OPEN_NOMUTEX, NULL);
    if (rc != SQLITE_OK) return fail(h, rc);
    sqlite3_busy_timeout(h->db, BUSY_TIMEOUT_MS);
    h->tomb_rc = read_tombstones(h, tombstone_sql);
    return SQLITE_OK;
}

static uint64_t hash_bytes(const unsigned char *p, int64_t n) {
    uint64_t x = 1469598103934665603ull; /* FNV-1a */
    for (int64_t k = 0; k < n; k++) x = (x ^ p[k]) * 1099511628211ull;
    return x;
}

static int same_name(const tpud_reader *h, int64_t k, const char *p, int64_t n) {
    int64_t start = k ? h->name_ends[k - 1] : 0;
    return h->name_ends[k] - start == n && memcmp(h->names + start, p, n) == 0;
}

static uint64_t name_slot(const char *p, int64_t n, int64_t n_slots) {
    return hash_bytes((const unsigned char *)p, n) & (n_slots - 1);
}

static int grow_slots(tpud_reader *h) {
    int64_t n = h->n_slots ? 2 * h->n_slots : 256;
    int64_t *slots = calloc(n, sizeof *slots);
    if (!slots) return SQLITE_NOMEM;
    for (int64_t k = 0, start = 0; k < h->n_links; start = h->name_ends[k++]) {
        uint64_t s = name_slot(h->names + start, h->name_ends[k] - start, n);
        while (slots[s]) s = (s + 1) & (n - 1);
        slots[s] = k + 1;
    }
    free(h->slots);
    h->slots = slots;
    h->n_slots = n;
    return SQLITE_OK;
}

/* The link's id, numbered in the order first fetched; -1 out of memory. */
static int64_t link_id(tpud_reader *h, const char *p, int64_t n) {
    uint64_t s = name_slot(p, n, h->n_slots);
    for (; h->slots[s]; s = (s + 1) & (h->n_slots - 1)) {
        if (same_name(h, h->slots[s] - 1, p, n)) return h->slots[s] - 1;
    }
    int64_t id = h->n_links, used = id ? h->name_ends[id - 1] : 0;
    if (id == h->ends_cap) {
        int64_t cap = id ? 2 * id : 256;
        int64_t *ends = realloc(h->name_ends, cap * sizeof *ends);
        if (!ends) return -1;
        h->name_ends = ends;
        h->ends_cap = cap;
    }
    if (used + n > h->names_cap) {
        int64_t cap = 2 * h->names_cap > used + n ? 2 * h->names_cap : used + n + 4096;
        char *names = realloc(h->names, cap);
        if (!names) return -1;
        h->names = names;
        h->names_cap = cap;
    }
    if (n) memcpy(h->names + used, p, n);
    h->name_ends[id] = used + n;
    h->n_links++;
    h->slots[s] = id + 1;
    if (2 * h->n_links > h->n_slots && grow_slots(h)) return -1;
    return id;
}

static int resize_columns(tpud_reader *h, int64_t cap) {
    void *p;
    if (!(p = realloc(h->lid, cap * sizeof *h->lid))) return SQLITE_NOMEM;
    h->lid = p;
    if (!(p = realloc(h->ts, cap * sizeof *h->ts))) return SQLITE_NOMEM;
    h->ts = p;
    if (!(p = realloc(h->state, cap * sizeof *h->state))) return SQLITE_NOMEM;
    h->state = p;
    if (!(p = realloc(h->crc, cap * sizeof *h->crc))) return SQLITE_NOMEM;
    h->crc = p;
    h->cap = cap;
    return SQLITE_OK;
}

/* Columns c0.. of the newest row; TPUD_VALUE where the caller converts. */
static int fill(tpud_reader *h, int c0) {
    sqlite3_stmt *st = h->stmt;
    int64_t r = h->n_rows - 1, v;
    for (int c = c0; c < 4; c++) {
        int type = sqlite3_column_type(st, c);
        if (c == 0 && type == SQLITE_TEXT) {
            const char *p = (const char *)sqlite3_column_text(st, 0);
            int64_t id = link_id(h, p, sqlite3_column_bytes(st, 0));
            if (id < 0) return SQLITE_NOMEM;
            h->lid[r] = (int32_t)id;
        } else if (c == 1 && (type == SQLITE_FLOAT || type == SQLITE_INTEGER)) {
            h->ts[r] = sqlite3_column_double(st, 1);
        } else if (c == 2 && type == SQLITE_INTEGER
                   && (v = sqlite3_column_int64(st, 2)) >= -128 && v <= 127) {
            h->state[r] = (int8_t)v;
        } else if (c == 3 && type == SQLITE_INTEGER) {
            h->crc[r] = sqlite3_column_int64(st, 3);
        } else {
            h->bad_col = c;
            h->bad = column_value(st, c);
            return TPUD_VALUE;
        }
    }
    return SQLITE_OK;
}

static int walk(tpud_reader *h) {
    for (;;) {
        int rc = sqlite3_step(h->stmt);
        if (rc == SQLITE_DONE) {
            finish(h);
            return SQLITE_DONE;
        }
        if (rc != SQLITE_ROW) return fail(h, rc);
        if (h->n_rows == h->cap && resize_columns(h, 2 * h->cap)) return SQLITE_NOMEM;
        h->n_rows++;
        if ((rc = fill(h, 0))) return rc;
    }
}

int tpud_window(tpud_reader *h, const char *sql, double start, int64_t rows0) {
    int rc = sqlite3_prepare_v2(h->db, sql, -1, &h->stmt, NULL);
    if (rc != SQLITE_OK) return fail(h, rc);
    if ((rc = sqlite3_bind_double(h->stmt, 1, start)) != SQLITE_OK) return fail(h, rc);
    if (resize_columns(h, rows0) || grow_slots(h)) return SQLITE_NOMEM;
    return walk(h);
}

/* Stores the caller's conversion of the value that stopped the walk (f for
 * ts, i for state and CRC) and walks on. */
int tpud_resume(tpud_reader *h, double f, int64_t i) {
    int64_t r = h->n_rows - 1;
    if (h->bad_col == 1) h->ts[r] = f;
    else if (h->bad_col == 2) h->state[r] = (int8_t)i;
    else h->crc[r] = i;
    int rc = fill(h, (int)h->bad_col + 1);
    return rc ? rc : walk(h);
}

void tpud_close(tpud_reader *h) {
    if (!h) return;
    finish(h);
    free(h->errmsg);
    free_values(h->tombstones, 2 * h->n_tombstones);
    free(h->names);
    free(h->name_ends);
    free(h->lid);
    free(h->ts);
    free(h->state);
    free(h->crc);
    free(h->slots);
    free(h);
}
